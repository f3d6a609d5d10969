// Tile variants of the port's linear_mma (sdm_tpu_torch/csrc/linear.cu),
// for tools/torch_linear_tiles.py. Each variant is one instantiation of
// launch_linear_mma<BM, BN, WM, WN, BK, STAGES, MIN_BLOCKS_PER_SM>.
#include "../sdm_tpu_torch/csrc/linear.cu"

#define LINEAR_VARIANTS(X)          \
  X(0, 128, 128, 2, 4, 32, 4, 2)    \
  X(1, 64, 64, 2, 2, 32, 4, 4)      \
  X(2, 128, 128, 2, 2, 32, 4, 2)    \
  X(3, 128, 128, 2, 4, 32, 5, 2)    \
  X(4, 128, 256, 2, 4, 64, 3, 1)    \
  X(5, 256, 128, 4, 2, 64, 4, 1)    \
  X(6, 128, 256, 4, 4, 32, 4, 1)    \
  X(7, 64, 128, 2, 2, 32, 4, 3)

// The variant's launch; `no_memory` passes M = N = 1 on the full grid, so
// every block but one zero-fills its ring (no global reads) and stores
// nothing: the shared-memory pipeline and the mma.sync alone.
#define LINEAR_CASE(id, BM, BN, WM, WN, BK, ST, MB)                          \
  case id:                                                                   \
    if (no_memory) {                                                         \
      auto kernel = &linear_mma<BM, BN, WM, WN, BK, ST, MB>;                 \
      const size_t smem = (size_t)ST * (BM + BN) * (BK + 8) * sizeof(bf16); \
      cudaFuncSetAttribute(                                                  \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);  \
      kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), 32 * WM * WN,    \
               smem, stream>>>(xp, K, wp, bias, bias_dt, nullptr, yp, 1, 1, \
                               K);                                           \
      return (int)cudaGetLastError();                                        \
    }                                                                        \
    return (int)launch_linear_mma<BM, BN, WM, WN, BK, ST, MB>(               \
        xp, K, wp, bias, bias_dt, rp, yp, M, N, K, stream);

SDM_EXPORT int tiles_linear(int variant, int no_memory, const void* x,
                            const void* w, const void* bias, int bias_dt,
                            const void* res, void* y, int M, int N, int K,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* rp = static_cast<const bf16*>(res);
  bf16* yp = static_cast<bf16*>(y);
  switch (variant) { LINEAR_VARIANTS(LINEAR_CASE) }
  return -1;
}

#define LINEAR_NAME(id, BM, BN, WM, WN, BK, ST, MB)                          \
  case id:                                                                   \
    return #BM "x" #BN " blocks, " #WM "x" #WN " warps, BK " #BK ", " #ST    \
           " stages, " #MB " blocks/SM";

SDM_EXPORT const char* tiles_linear_name(int variant) {
  switch (variant) { LINEAR_VARIANTS(LINEAR_NAME) }
  return nullptr;
}
