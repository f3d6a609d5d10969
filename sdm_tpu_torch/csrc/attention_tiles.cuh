// Tile helpers and the CUDA-core softmax statistics (attn_stats) shared by
// the whole-S attention (attention.cu) and the streaming attention
// (streaming_attention.cu). The tensor-core kernels are on TMA + wgmma
// (wgmma_tiles.cuh): the whole-S attention's in attention.cu, the streaming
// attention's (forward, dV, dK and dQ) in streaming_attention.cu.
//
// The stats kernels compute, per kept row a, m_a = max_r s_ar and l_a =
// sum_r exp(s_ar - m_a) over ALL S reduced rows, with s_ar = scale *
// <kept_a, red_r>: column stats for the query-axis softmax (keys kept,
// queries reduced), row stats for the key axis. The grid is (kept-row tiles,
// batch*heads) and each block loops over the reduced tiles, merging (m, l)
// online, so shared memory does not depend on S. Reduced rows past S count
// as -inf.
//
// The kernels take a caller tag (whole_s or streaming, or a pass tag of the
// streaming kernels) as a template argument, so a profiler trace names them
// apart: attn_stats<float, whole_s> is the whole-S attention's fp32 stats
// pass, stream_apply_wgmma<false, float, 4, 8, dv_pass> the query-axis dV
// pass at D = 512.
#pragma once

#include "common.cuh"

#define BK 32      // depth of one staged D chunk (CUDA-core kernels)
#define SBN 64     // kept rows per stats block
#define MAX_SMEM 232448  // opt-in shared memory per block on sm_90, bytes

struct View {
  long long sn, sh, ss;  // element strides of the N, H and S axes
};

struct whole_s {};     // caller tags of the shared kernels
struct streaming {};

template <typename T>
__device__ __forceinline__ const T* slice_ptr(const T* base, View v, int heads,
                                              int b) {
  return base + (long long)(b / heads) * v.sn + (long long)(b % heads) * v.sh;
}

template <typename T>
__device__ __forceinline__ T* slice_ptr(T* base, View v, int heads, int b) {
  return base + (long long)(b / heads) * v.sn + (long long)(b % heads) * v.sh;
}

// 16-byte aligned base pointers and N, H and S strides that are multiples of
// 8 elements, so every row of every slice starts on 16 bytes (strided views
// of a qkv buffer qualify).
static bool rows_aligned16(const void* const* ptrs, const View* views,
                           int n) {
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i]) || views[i].sn % 8 || views[i].sh % 8 ||
        views[i].ss % 8)
      return false;
  return true;
}

// Rows [r0, r0+R) x columns [d0, d0+BK) of a (rows, D) matrix with row stride
// ss, transposed into dst[BK][ld]; out-of-range entries are zero.
template <typename T, int R>
__device__ __forceinline__ void load_tile_t(float* dst, int ld, const T* p,
                                            long long ss, int r0, int nrows,
                                            int d0, int d) {
  for (int e = threadIdx.x; e < R * BK; e += blockDim.x) {
    const int r = e / BK, kk = e - r * BK;
    float val = 0.f;
    if (r0 + r < nrows && d0 + kk < d)
      val = sdm_to_float(p[(long long)(r0 + r) * ss + d0 + kk]);
    dst[kk * ld + r] = val;
  }
}

// CUDA-core stats (fp32 FMA), any S and D.
template <typename T, typename Caller>
__global__ void __launch_bounds__(256)
attn_stats(const T* __restrict__ kept, View kv, const T* __restrict__ red,
           View rv, int heads, int S, int D, float scale,
           float* __restrict__ m_out, float* __restrict__ l_out) {
  __shared__ float As[BK * (SBN + 1)];
  __shared__ float Bs[BK * (SBN + 1)];
  __shared__ float St[SBN * (SBN + 1)];
  const int b = blockIdx.y;
  const T* kp = slice_ptr(kept, kv, heads, b);
  const T* rp = slice_ptr(red, rv, heads, b);
  const int a0 = blockIdx.x * SBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ld = SBN + 1;

  float m = -INFINITY, l = 0.f;
  for (int r0 = 0; r0 < S; r0 += SBN) {
    float acc[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += BK) {
      load_tile_t<T, SBN>(As, ld, kp, kv.ss, a0, S, d0, D);
      load_tile_t<T, SBN>(Bs, ld, rp, rv.ss, r0, S, d0, D);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk * ld + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * ld + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        St[(ty + 16 * i) * ld + col] =
            r0 + col < S ? acc[i][j] * scale : -INFINITY;
      }
    __syncthreads();
    if (threadIdx.x < SBN) {
      const float* row = St + threadIdx.x * ld;
      float tmax = -INFINITY;
      for (int c = 0; c < SBN; ++c) tmax = fmaxf(tmax, row[c]);
      const float mn = fmaxf(m, tmax);
      float sum = 0.f;
      for (int c = 0; c < SBN; ++c) sum += expf(row[c] - mn);
      l = l * expf(m - mn) + sum;
      m = mn;
    }
    __syncthreads();
  }
  if (threadIdx.x < SBN && a0 + threadIdx.x < S) {
    m_out[(long long)b * S + a0 + threadIdx.x] = m;
    l_out[(long long)b * S + a0 + threadIdx.x] = l;
  }
}

// Launch the stats pass. Query axis: column stats (keys kept, queries
// reduced); key axis: row stats (queries kept, keys reduced).
template <typename Caller, typename T>
static cudaError_t launch_stats(const T* qp, View qv, const T* kp, View kv,
                                int bh, int heads, int S, int D, float scale,
                                int axis_q, float* m, float* l,
                                cudaStream_t stream) {
  const dim3 grid((S + SBN - 1) / SBN, bh);
  if (axis_q)
    attn_stats<T, Caller><<<grid, 256, 0, stream>>>(kp, kv, qp, qv, heads, S,
                                                    D, scale, m, l);
  else
    attn_stats<T, Caller><<<grid, 256, 0, stream>>>(qp, qv, kp, kv, heads, S,
                                                    D, scale, m, l);
  return cudaGetLastError();
}
