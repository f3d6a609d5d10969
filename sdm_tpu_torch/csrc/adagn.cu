// Fused AdaGN forward: GroupNorm statistics + GN affine + FiLM modulation.
//
// Replaces the TPU kernel sdm_tpu/kernels/adagn.py::fused_adagn
// (_adagn_kernel, one whole-sample VMEM tile per grid step). On the H100 the
// work is a reduction followed by one elementwise pass, with no matrix work:
// it is bound by device-memory bytes (read x, write out). Design:
//
//   1. adagn_stats, grid (G, N): one block per (group, sample). Two passes in
//      fp32 over the group's H*W x C/G elements: the mean, then
//      E[(x - mean)^2] (the TPU kernel's one-pass E[x^2] - mean^2 cancels at
//      large means). The block then folds GN affine and FiLM into per-channel
//      a = inv*gamma*s and b = s*(beta - mean*inv*gamma) + t, written to an
//      fp32 (2, N, C) scratch. Blocks of one sample are adjacent in launch
//      order, so the second pass and the neighbouring groups' reads of the
//      same sectors come from L2.
//   2. adagn_apply: one vectorised pass, 8 elements per thread,
//      out = x*a[n,c] + b[n,c], rounded once to the output type.
//
// x is (N, H*W, C) contiguous (an NCHW channels_last activation viewed as
// NHWC); C % 8 == 0 and 16-byte aligned pointers (checked by the wrapper).
#include "common.cuh"

__global__ void adagn_stats(const void* __restrict__ x, int x_dt,
                            const void* __restrict__ gamma,
                            const void* __restrict__ beta, int p_dt,
                            const void* __restrict__ s,
                            const void* __restrict__ t, int f_dt,
                            long long f_row_stride, float* __restrict__ a_out,
                            float* __restrict__ b_out, int hw, int c,
                            int groups, float eps) {
  __shared__ float red[32];
  const int g = blockIdx.x, n = blockIdx.y;
  const int cg = c / groups;
  const long long base = (long long)n * hw * c + (long long)g * cg;
  const int count = hw * cg;

  float acc = 0.f;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cg, col = e - r * cg;
    acc += sdm_load(x, base + (long long)r * c + col, x_dt);
  }
  const float mean = sdm_block_sum(acc, red) / (float)count;

  acc = 0.f;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cg, col = e - r * cg;
    const float d = sdm_load(x, base + (long long)r * c + col, x_dt) - mean;
    acc += d * d;
  }
  const float var = sdm_block_sum(acc, red) / (float)count;
  const float inv = 1.f / sqrtf(var + eps);

  for (int j = threadIdx.x; j < cg; j += blockDim.x) {
    const int ch = g * cg + j;
    const float gm = sdm_load(gamma, ch, p_dt);
    const float bt = sdm_load(beta, ch, p_dt);
    const float sc = sdm_load(s, n * f_row_stride + ch, f_dt);
    const float sh = sdm_load(t, n * f_row_stride + ch, f_dt);
    a_out[(long long)n * c + ch] = inv * gm * sc;
    b_out[(long long)n * c + ch] = sc * (bt - mean * inv * gm) + sh;
  }
}

template <typename TI, typename TO>
__global__ void adagn_apply(const TI* __restrict__ x, TO* __restrict__ out,
                            const float* __restrict__ a,
                            const float* __restrict__ b, long long total,
                            long long hwc, int c) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= total) return;
  const int n = (int)(i / hwc);
  const int ch = (int)(i % c);
  const float* an = a + (long long)n * c + ch;
  const float* bn = b + (long long)n * c + ch;
  float v[8];
  sdm_load8(x + i, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = v[k] * an[k] + bn[k];
  sdm_store8(out + i, v);
}

template <typename TI, typename TO>
static void launch_apply(const void* x, void* out, const float* a,
                         const float* b, long long total, long long hwc, int c,
                         cudaStream_t stream) {
  const int threads = 256;
  const long long vecs = total / 8;
  const unsigned blocks = (unsigned)((vecs + threads - 1) / threads);
  adagn_apply<TI, TO><<<blocks, threads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), a, b, total, hwc, c);
}

// Returns cudaGetLastError() after both launches (0 = success).
SDM_EXPORT int sdm_adagn_forward(const void* x, const void* gamma,
                                 const void* beta, const void* s,
                                 const void* t, void* out, float* ab_scratch,
                                 int n, int hw, int c, int groups, float eps,
                                 long long f_row_stride, int x_dt, int p_dt,
                                 int f_dt, int out_dt, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* a = ab_scratch;
  float* b = ab_scratch + (long long)n * c;
  adagn_stats<<<dim3(groups, n), 256, 0, stream>>>(
      x, x_dt, gamma, beta, p_dt, s, t, f_dt, f_row_stride, a, b, hw, c,
      groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * hw * c;
  const long long hwc = (long long)hw * c;
  if (x_dt == SDM_F32 && out_dt == SDM_F32)
    launch_apply<float, float>(x, out, a, b, total, hwc, c, stream);
  else if (x_dt == SDM_F32 && out_dt == SDM_BF16)
    launch_apply<float, __nv_bfloat16>(x, out, a, b, total, hwc, c, stream);
  else if (x_dt == SDM_BF16 && out_dt == SDM_F32)
    launch_apply<__nv_bfloat16, float>(x, out, a, b, total, hwc, c, stream);
  else
    launch_apply<__nv_bfloat16, __nv_bfloat16>(x, out, a, b, total, hwc, c,
                                               stream);
  return (int)cudaGetLastError();
}
