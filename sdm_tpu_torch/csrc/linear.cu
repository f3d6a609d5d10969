// Tiled GEMM with a bias (+ residual) epilogue: y = T(x W^T + b) [+ res].
//
// The two projections of the attention block kernel, which the TPU kernel
// sdm_tpu/kernels/attention_block.py::fused_attention_block computes in its
// own body (_block_kernel: qkv = tok W_qkv + b, out = r W_out + b_out + tok).
// On the H100 the block's weights (W_qkv alone is 512 x 1536) do not fit one
// SM next to the token tile, so the block runs as three hand-written kernels:
// this GEMM for the qkv projection, the attention kernel (attention.cu), and
// this GEMM again with the residual epilogue for the output projection.
//
// Rounding follows the JAX composite: fp32 accumulation, fp32 bias added,
// one rounding to T; the residual is added to that rounded value and rounded
// again (JAX adds the tokens in the compute dtype).
//
// x is (M, K) with row stride ldx and a unit column stride; w is the
// nn.Linear weight (N, K), contiguous. Two paths:
//   - bf16 with K % 32 == 0 and 16-byte aligned rows (every flagship shape):
//     linear_wmma, tensor cores through WMMA (bf16 products, fp32
//     accumulation), 128 x 128 output tiles;
//   - otherwise linear_nt: fp32 FMA on the CUDA cores, 64 x 64 tiles with a
//     4 x 4 register tile per thread.
// At the flagship shapes (M = 16*1024, K = 512, N = 1536) the GEMM is bound
// by operations. Neither path pipelines its loads (no cp.async / TMA) or
// uses wgmma yet: that is later work.
#include "common.cuh"

#include <mma.h>

#define TM 64
#define TN 64
#define TK 32

template <typename T>
__global__ void __launch_bounds__(256)
linear_nt(const T* __restrict__ x, long long ldx, const T* __restrict__ w,
          const void* __restrict__ bias, int bias_dt,
          const T* __restrict__ res, T* __restrict__ y, int M, int N, int K) {
  __shared__ float As[TK * (TM + 1)];
  __shared__ float Bs[TK * (TN + 1)];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += blockDim.x) {
      const int r = e / TK, kk = e - r * TK;
      float a = 0.f, bw = 0.f;
      if (k0 + kk < K) {
        if (m0 + r < M) a = sdm_to_float(x[(long long)(m0 + r) * ldx + k0 + kk]);
        if (n0 + r < N) bw = sdm_to_float(w[(long long)(n0 + r) * K + k0 + kk]);
      }
      As[kk * (TM + 1) + r] = a;
      Bs[kk * (TN + 1) + r] = bw;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * (TM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * (TN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float val = sdm_round<T>(acc[i][j] + sdm_load(bias, n, bias_dt));
      if (res != nullptr) val += sdm_to_float(res[(long long)m * N + n]);
      y[(long long)m * N + n] = sdm_from_float<T>(val);
    }
  }
}

// Tensor-core path for bf16 (WMMA 16x16x16, fp32 accumulation): 128 x 128
// output tiles, 8 warps of 64 x 32, K staged 32 at a time with 16-byte
// loads. Taken when K % 32 == 0 and rows are 16-byte aligned.
#define GM 128
#define GN 128
#define GK 32
#define GLD (GK + 8)

typedef __nv_bfloat16 bf16;

__global__ void __launch_bounds__(256)
linear_wmma(const bf16* __restrict__ x, long long ldx,
            const bf16* __restrict__ w, const void* __restrict__ bias,
            int bias_dt, const bf16* __restrict__ res, bf16* __restrict__ y,
            int M, int N, int K) {
  __shared__ __align__(128) bf16 As[GM * GLD];
  __shared__ __align__(128) bf16 Bs[GN * GLD];
  __shared__ __align__(128) float Cs[8 * 256];
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;   // rows wm*64, cols wn*32
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GK) {
    for (int c = threadIdx.x; c < GM * (GK / 8); c += blockDim.x) {
      const int r = c / (GK / 8), kc = (c % (GK / 8)) * 8;
      uint4 a = make_uint4(0, 0, 0, 0), bw = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        a = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * ldx +
                                            k0 + kc);
      if (n0 + r < N)
        bw = *reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * K +
                                             k0 + kc);
      *reinterpret_cast<uint4*>(As + r * GLD + kc) = a;
      *reinterpret_cast<uint4*>(Bs + r * GLD + kc) = bw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * GLD + kk, GLD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wm * 64 + i * 16) * GLD + kk, GLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* cs = Cs + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 64 + i * 16 + (e >> 4);
        const int n = n0 + wn * 32 + j * 16 + (e & 15);
        if (m < M && n < N) {
          float val = sdm_round<bf16>(cs[e] + sdm_load(bias, n, bias_dt));
          if (res != nullptr) val += __bfloat162float(res[(long long)m * N + n]);
          y[(long long)m * N + n] = __float2bfloat16_rn(val);
        }
      }
      __syncwarp();
    }
}

// res may be null. Returns cudaGetLastError() after the launch.
SDM_EXPORT int sdm_linear_forward(const void* x, long long ldx, const void* w,
                                  const void* bias, int bias_dt,
                                  const void* res, void* y, int M, int N,
                                  int K, int dt, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const bool wmma_ok =
      dt == SDM_BF16 && K % GK == 0 && ldx % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (wmma_ok)
    linear_wmma<<<dim3((N + GN - 1) / GN, (M + GM - 1) / GM), 256, 0,
                  stream>>>(static_cast<const bf16*>(x), ldx,
                            static_cast<const bf16*>(w), bias, bias_dt,
                            static_cast<const bf16*>(res),
                            static_cast<bf16*>(y), M, N, K);
  else if (dt == SDM_F32)
    linear_nt<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), ldx, static_cast<const float*>(w), bias,
        bias_dt, static_cast<const float*>(res), static_cast<float*>(y), M, N,
        K);
  else
    linear_nt<__nv_bfloat16><<<grid, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), ldx,
        static_cast<const __nv_bfloat16*>(w), bias, bias_dt,
        static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(y), M, N, K);
  return (int)cudaGetLastError();
}
