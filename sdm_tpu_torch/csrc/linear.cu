// `linear` alone: y = T(x W^T + b) [+ res], the GEMM of linear_kernels.cuh
// (linear_wgmma on the tensor cores, linear_nt on the CUDA cores), for
// kernels/attention_block.py::linear.
#include "wgmma_tiles.cuh"
#include "linear_kernels.cuh"

// Whether sdm_linear_forward takes the tensor-core path for these operands
// (res may be null).
SDM_EXPORT int sdm_linear_takes_wgmma(const void* x, long long ldx,
                                      const void* w, const void* res, int K,
                                      int dt) {
  return linear_wgmma_ok(x, ldx, w, res, K, dt);
}

// linear_wgmma's block tile for an M x N output: 0 the large, 1 the small.
SDM_EXPORT int sdm_linear_wgmma_tile(int M, int N) {
  return linear_wgmma_tile(M, N);
}

// res may be null. Returns cudaGetLastError() after the launch, or the
// error of encoding the TMA maps.
SDM_EXPORT int sdm_linear_forward(const void* x, long long ldx, const void* w,
                                  const void* bias, int bias_dt,
                                  const void* res, void* y, int M, int N,
                                  int K, int dt, void* stream_ptr) {
  return linear_forward(x, ldx, w, bias, bias_dt, res, y, M, N, K, dt,
                        static_cast<cudaStream_t>(stream_ptr));
}
