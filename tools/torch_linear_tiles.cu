// Tile variants of the port's linear_wgmma (sdm_tpu_torch/csrc/linear.cu),
// for tools/torch_linear_tiles.py. Each variant is one instantiation of
// launch_linear_wgmma<BN, consumer warpgroups, STAGES, MIN_BLOCKS_PER_SM,
// VEC> (the block tile is 64 x warpgroups by BN; VEC the 16-byte epilogue),
// one block a tile or persistent.
#include "../sdm_tpu_torch/csrc/linear.cu"

// X(id, BN, warpgroups, stages, blocks/SM, 16-byte epilogue, persistent)
#define LINEAR_VARIANTS(X)         \
  X(0, 128, 2, 3, 2, false, false) \
  X(1, 128, 2, 3, 2, true, false)  \
  X(2, 128, 2, 3, 2, true, true)   \
  X(3, 128, 2, 3, 2, false, true)  \
  X(4, 256, 2, 4, 1, true, true)   \
  X(5, 256, 2, 3, 1, true, true)   \
  X(6, 64, 2, 4, 2, true, false)   \
  X(7, 64, 2, 4, 2, true, true)    \
  X(8, 128, 1, 4, 2, true, true)   \
  X(9, 128, 2, 4, 1, true, true)   \
  X(10, 256, 1, 4, 1, true, true)

// The variant's launch; `no_memory` runs the M x N tiles on a 1 x 1
// output, so every TMA box but one is zero-filled (no global reads) and one
// element is stored: the TMA ring and the wgmma alone. A persistent
// variant launches blocks/SM x LSMS blocks that walk the tiles.
#define LINEAR_CASE(id, BN, WG, ST, MB, VEC, PERSIST)                        \
  case id:                                                                   \
    return launch_linear_wgmma<BN, WG, ST, MB, VEC>(                         \
        xp, K, wp, bias, bias_dt, rp, yp, no_memory ? 1 : M,                 \
        no_memory ? 1 : N, K, stream, M, N, PERSIST ? MB * LSMS : 0);

SDM_EXPORT int tiles_linear(int variant, int no_memory, const void* x,
                            const void* w, const void* bias, int bias_dt,
                            const void* res, void* y, int M, int N, int K,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* rp = no_memory ? nullptr : static_cast<const bf16*>(res);
  bf16* yp = static_cast<bf16*>(y);
  switch (variant) { LINEAR_VARIANTS(LINEAR_CASE) }
  return -1;
}

#define LINEAR_NAME(id, BN, WG, ST, MB, VEC, PERSIST)                       \
  case id:                                                                   \
    return "64 x " #WG " by " #BN " blocks (" #WG " consumer warpgroups), " \
        #ST " stages, " #MB " blocks/SM, 16-byte epilogue " #VEC             \
        ", persistent " #PERSIST;

SDM_EXPORT const char* tiles_linear_name(int variant) {
  switch (variant) { LINEAR_VARIANTS(LINEAR_NAME) }
  return nullptr;
}
