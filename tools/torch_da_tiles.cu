// Tiling variants of the streaming backward's dA kernel, stream_da_mma
// (sdm_tpu_torch/csrc/streaming_attention.cu), for tools/torch_da_tiles.py.
// Each variant is one instantiation of launch_da_mma<Pass, BM, BN, KSPLIT>:
// own rows per block, streamed rows per ring stage, D slices per score tile.
#include "../sdm_tpu_torch/csrc/streaming_attention.cu"

#define DA_VARIANTS(X) \
  X(0, 32, 32, 1)      \
  X(1, 32, 32, 2)      \
  X(2, 64, 16, 1)      \
  X(3, 64, 16, 2)

#define DA_CASE(id, BM, BN, KS)                                              \
  case id:                                                                   \
    if (da_mma_smem_bytes<BM, BN, KS>(D) > MAX_SMEM || S % BM || S % BN)     \
      return -2;                                                             \
    return (int)launch_da_mma<dq_pass, BM, BN, KS>(                          \
        static_cast<const bf16*>(a), static_cast<const bf16*>(a2),           \
        static_cast<const bf16*>(b), static_cast<const bf16*>(b2), o, views, \
        batch, S, D, scale, stat_col, m, l, c, stream);

// out = scale sum_b round(dA_ab) B_b as sdm_streaming_dq computes it, with
// the roles already assigned: strides (sb, ss) of A, A2, B, B2 and out.
SDM_EXPORT int tiles_da(int variant, const void* a, const void* a2,
                        const void* b, const void* b2, float* o,
                        const long long* strides, int batch, int S, int D,
                        float scale, int stat_col, const float* m,
                        const float* l, const float* c, void* stream_ptr) {
  View views[5];
  read_views(strides, views, 5);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (variant) { DA_VARIANTS(DA_CASE) }
  return -1;
}

#define DA_NAME(id, BM, BN, KS) \
  case id:                      \
    return #BM " own rows, " #BN "-row tiles, KSPLIT " #KS;

SDM_EXPORT const char* tiles_da_name(int variant) {
  switch (variant) { DA_VARIANTS(DA_NAME) }
  return nullptr;
}
