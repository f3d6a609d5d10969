// Fused AdaGN forward: GroupNorm statistics + GN affine + FiLM modulation.
//
// Replaces the TPU kernel sdm_tpu/kernels/adagn.py::fused_adagn
// (_adagn_kernel, one whole-sample VMEM tile per grid step). On the H100 the
// work is a reduction followed by one elementwise pass, with no matrix work:
// it is bound by device-memory bytes (read x, write out). Two launches, each
// over a (chunks, N) grid: sample n's H*W rows cut into `chunks` contiguous
// row ranges, chunks chosen by the wrapper (kernels/adagn.py::adagn_chunks)
// so that the grid is about two blocks per SM. In both passes thread (tx,
// ty) of a block owns the 8 consecutive channels of 16-byte vector tx (one
// sdm_load8 a row: neighbouring threads on neighbouring addresses) and
// walks rows ty, ty + R, ... of the chunk, R = ATHREADS / (C / 8) rows at a
// time (where C / 8 > ATHREADS, column groups of ATHREADS vectors in turn).
//
//   1. adagn_stats reads x once, AUNROLL rows of a thread in flight at a
//      time. Each thread keeps a running (count, mean, M2) per channel in
//      fp32 registers: each group of AUNROLL rows' own mean and M2, merged
//      in by Chan's formula (Welford's update for the rows left over), never
//      E[x^2] - mean^2, which cancels at large means. The R row lanes of a
//      vector merge in shared memory by Chan's formula, in a fixed order;
//      then the chunk's channels merge into their groups (equal counts n:
//      mean_g = mean of the mean_c, M2_g = sum M2_c + n sum (mean_c -
//      mean_g)^2). Channels merge per channel first because a group of C/G
//      channels (12 at C = 384) need not align with the 8-channel vectors.
//      The block writes (mean, M2) of each group, an fp32 (N, chunks, G, 2)
//      scratch: the apply's prologue then reads chunks * G pairs, not
//      chunks * C.
//   2. adagn_apply's prologue stages sample n's chunks * G partials in
//      shared memory and merges them per group in chunk order (Chan), then
//      folds GN affine and FiLM into per-channel a = inv*gamma*s and b =
//      s*beta + t, held in registers with the group mean for the thread's 8
//      channels; it then reads x and writes (x - mean)*a + b once, 16 bytes
//      a load, rounded once to the output type (centring first: x*a' + b'
//      with b' = b - mean*a would cancel at large means). Its blocks run in
//      the reverse order of the stats pass, so the chunks the stats read
//      last, the likeliest still in L2, are read first.
// No atomics: every merge has a fixed order, so a run gives the same bits
// twice.
//
// What this design does about the kernel it replaced: that one ran a (G, N)
// grid, each block walking its group's C/G channels row by row at stride C
// with scalar loads through a per-element dtype switch (at C = 128, 8 bytes
// of each 32-byte sector), and read x twice (mean, then variance) before
// the apply read it a third time with 16 scalar loads of a and b per 8
// elements.
//
// x is (N, H*W, C) contiguous (an NCHW channels_last activation viewed as
// NHWC); C % 8 == 0 and 16-byte aligned pointers (checked by the wrapper).
#include "common.cuh"

#define ATHREADS 256   // threads per block of both passes
#define AUNROLL 4      // rows a thread has in flight (2 and 8 were slower)
#define ASMEM 49152    // dynamic shared memory without the opt-in, bytes

// Welford's update of 8 channels' (mean, M2) by one row, inv_k = 1 / the
// row count so far.
__device__ __forceinline__ void welford8(float mean[8], float m2[8],
                                         const float v[8], float inv_k) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d = v[e] - mean[e];
    mean[e] += d * inv_k;
    m2[e] += d * (v[e] - mean[e]);
  }
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a); nb may be 0.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nab = na + nb;
  const float d = mb - ma;
  const float f = nb / nab;
  ma += d * f;
  m2a += m2b + d * d * na * f;
  na = nab;
}

// Rows [r0, r1) of chunk p of `chunks` over hw rows.
__device__ __forceinline__ void chunk_rows(int p, int chunks, int hw, int& r0,
                                           int& r1) {
  r0 = (int)((long long)p * hw / chunks);
  r1 = (int)((long long)(p + 1) * hw / chunks);
}

// Vectors across a block row (vt) and row lanes (rl) for C channels.
__device__ __forceinline__ void block_layout(int c, int& vt, int& rl) {
  vt = min(c / 8, ATHREADS);
  rl = ATHREADS / vt;
}

template <typename TI>
__global__ void __launch_bounds__(ATHREADS)
adagn_stats(const TI* __restrict__ x, float2* __restrict__ part, int hw,
            int c, int groups, int chunks) {
  extern __shared__ __align__(16) float sm[];
  float* lmean = sm;                    // [rl][vt][8] row-lane partials
  float* lm2 = sm + ATHREADS * 8;
  float* cmean = sm + 2 * ATHREADS * 8; // [C] the chunk's channel stats
  float* cm2 = cmean + c;

  const int p = blockIdx.x, n = blockIdx.y;
  int r0, r1;
  chunk_rows(p, chunks, hw, r0, r1);
  const int v = c / 8;
  int vt, rl;
  block_layout(c, vt, rl);
  const int tid = threadIdx.x, tx = tid % vt, ty = tid / vt;
  const bool lane_on = ty < rl;
  const TI* xn = x + (long long)n * hw * c;
  // Rows of row lane j: r0 + j, r0 + j + rl, ... below r1.
  auto lane_rows = [&](int j) {
    return r0 + j < r1 ? (r1 - r0 - j + rl - 1) / rl : 0;
  };

  for (int vb = 0; vb < v; vb += vt) {     // column groups of vt vectors
    const int vc = vb + tx;
    float mean[8], m2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) mean[e] = m2[e] = 0.f;
    if (lane_on && vc < v) {
      const TI* px = xn + vc * 8;
      int k = 0, r = r0 + ty;
      for (; r + (AUNROLL - 1) * rl < r1; r += AUNROLL * rl) {
        float xv[AUNROLL][8];
#pragma unroll
        for (int u = 0; u < AUNROLL; ++u)
          sdm_load8(px + (long long)(r + u * rl) * c, xv[u]);
        // The AUNROLL rows' own (mean, M2) per channel, merged in by Chan.
        const float f = (float)AUNROLL / (float)(k + AUNROLL);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float mu = 0.f;
#pragma unroll
          for (int u = 0; u < AUNROLL; ++u) mu += xv[u][e];
          mu *= 1.f / AUNROLL;
          float q = 0.f;
#pragma unroll
          for (int u = 0; u < AUNROLL; ++u)
            q += (xv[u][e] - mu) * (xv[u][e] - mu);
          const float d = mu - mean[e];
          mean[e] += d * f;
          m2[e] += q + d * d * (float)k * f;
        }
        k += AUNROLL;
      }
      for (; r < r1; r += rl) {
        float xv[8];
        sdm_load8(px + (long long)r * c, xv);
        ++k;
        welford8(mean, m2, xv, 1.f / (float)k);
      }
    }
    __syncthreads();   // the previous column group's partials are merged
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lmean[tid * 8 + e] = mean[e];
        lm2[tid * 8 + e] = m2[e];
      }
    }
    __syncthreads();
    // One thread per channel of the column group merges its rl row lanes.
    for (int ch = tid; ch < vt * 8; ch += ATHREADS) {
      if (vb + ch / 8 >= v) continue;
      float na = 0.f, ma = 0.f, m2a = 0.f;
      for (int j = 0; j < rl; ++j)
        chan_merge(na, ma, m2a, (float)lane_rows(j), lmean[j * vt * 8 + ch],
                   lm2[j * vt * 8 + ch]);
      cmean[vb * 8 + ch] = ma;
      cm2[vb * 8 + ch] = m2a;
    }
  }
  __syncthreads();
  // The chunk's channels into groups: every channel counts r1 - r0 rows.
  const int cg = c / groups;
  const float rows = (float)(r1 - r0);
  float2* out = part + ((long long)n * chunks + p) * groups;
  for (int gi = tid; gi < groups; gi += ATHREADS) {
    const float* gm = cmean + gi * cg;
    const float* g2 = cm2 + gi * cg;
    float mg = 0.f;
    for (int j = 0; j < cg; ++j) mg += gm[j];
    mg /= (float)cg;
    float m2g = 0.f, dev = 0.f;
    for (int j = 0; j < cg; ++j) {
      m2g += g2[j];
      const float d = gm[j] - mg;
      dev += d * d;
    }
    out[gi] = make_float2(mg, m2g + rows * dev);
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(ATHREADS)
adagn_apply(const TI* __restrict__ x, TO* __restrict__ out,
            const float2* __restrict__ part, const void* __restrict__ gamma,
            const void* __restrict__ beta, int p_dt,
            const void* __restrict__ s, const void* __restrict__ t, int f_dt,
            long long f_row_stride, int hw, int c, int groups, int chunks,
            float eps) {
  extern __shared__ __align__(16) float sm[];
  float2* parts = reinterpret_cast<float2*>(sm);   // [chunks][G]
  float* gmean = sm + 2 * chunks * groups;         // [G]
  float* ginv = gmean + groups;                    // [G]

  // Reverse launch order against the stats pass (see the header).
  const int p = chunks - 1 - blockIdx.x, n = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x;
  const int cg = c / groups;

  const float2* pn = part + (long long)n * chunks * groups;
  for (int i = tid; i < chunks * groups; i += ATHREADS) parts[i] = pn[i];
  __syncthreads();
  for (int gi = tid; gi < groups; gi += ATHREADS) {
    float na = 0.f, ma = 0.f, m2a = 0.f;
    for (int q = 0; q < chunks; ++q) {
      int q0, q1;
      chunk_rows(q, chunks, hw, q0, q1);
      const float2 pq = parts[q * groups + gi];
      chan_merge(na, ma, m2a, (float)(q1 - q0) * (float)cg, pq.x, pq.y);
    }
    gmean[gi] = ma;
    ginv[gi] = 1.f / sqrtf(m2a / na + eps);
  }
  __syncthreads();

  int r0, r1;
  chunk_rows(p, chunks, hw, r0, r1);
  const int v = c / 8;
  int vt, rl;
  block_layout(c, vt, rl);
  const int tx = tid % vt, ty = tid / vt;
  if (ty >= rl) return;
  const long long base = (long long)n * hw * c;
  for (int vb = 0; vb < v; vb += vt) {
    const int vc = vb + tx;
    if (vc >= v) break;
    float mu[8], a[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = vc * 8 + e;
      const int gi = ch / cg;
      const float gm = sdm_load(gamma, ch, p_dt);
      const float bt = sdm_load(beta, ch, p_dt);
      const float sc = sdm_load(s, n * f_row_stride + ch, f_dt);
      const float sh = sdm_load(t, n * f_row_stride + ch, f_dt);
      mu[e] = gmean[gi];
      a[e] = ginv[gi] * gm * sc;
      b[e] = sc * bt + sh;
    }
    const TI* px = x + base + vc * 8;
    TO* po = out + base + vc * 8;
    int r = r0 + ty;
    for (; r + (AUNROLL - 1) * rl < r1; r += AUNROLL * rl) {
      float xv[AUNROLL][8];
#pragma unroll
      for (int u = 0; u < AUNROLL; ++u)
        sdm_load8(px + (long long)(r + u * rl) * c, xv[u]);
#pragma unroll
      for (int u = 0; u < AUNROLL; ++u) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xv[u][e] = (xv[u][e] - mu[e]) * a[e] + b[e];
        sdm_store8(po + (long long)(r + u * rl) * c, xv[u]);
      }
    }
    for (; r < r1; r += rl) {
      float xv[8];
      sdm_load8(px + (long long)r * c, xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[e] = (xv[e] - mu[e]) * a[e] + b[e];
      sdm_store8(po + (long long)r * c, xv);
    }
  }
}

// Dynamic shared memory of each pass.
static size_t stats_smem_bytes(int c) {
  return (size_t)(2 * ATHREADS * 8 + 2 * c) * sizeof(float);
}

static size_t apply_smem_bytes(int groups, int chunks) {
  return (size_t)(2 * chunks * groups + 2 * groups) * sizeof(float);
}

template <typename K>
static void allow_smem(K kernel, size_t bytes) {
  if (bytes > ASMEM)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
}

template <typename TI, typename TO>
static cudaError_t launch_apply(const void* x, void* out, const float2* part,
                                const void* gamma, const void* beta, int p_dt,
                                const void* s, const void* t, int f_dt,
                                long long f_row_stride, int n, int hw, int c,
                                int groups, int chunks, float eps,
                                cudaStream_t stream) {
  const size_t smem = apply_smem_bytes(groups, chunks);
  allow_smem(adagn_apply<TI, TO>, smem);
  adagn_apply<TI, TO><<<dim3(chunks, n), ATHREADS, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), part, gamma, beta,
      p_dt, s, t, f_dt, f_row_stride, hw, c, groups, chunks, eps);
  return cudaGetLastError();
}

// scratch: (N, chunks, G, 2) fp32; 1 <= chunks <= hw. Returns
// cudaGetLastError() after both launches (0 = success).
SDM_EXPORT int sdm_adagn_forward(const void* x, const void* gamma,
                                 const void* beta, const void* s,
                                 const void* t, void* out, float* scratch,
                                 int n, int hw, int c, int groups, int chunks,
                                 float eps, long long f_row_stride, int x_dt,
                                 int p_dt, int f_dt, int out_dt,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (chunks < 1 || chunks > hw) return (int)cudaErrorInvalidValue;
  float2* part = reinterpret_cast<float2*>(scratch);
  const size_t smem = stats_smem_bytes(c);
  const dim3 grid(chunks, n);
  if (x_dt == SDM_F32) {
    allow_smem(adagn_stats<float>, smem);
    adagn_stats<float><<<grid, ATHREADS, smem, stream>>>(
        static_cast<const float*>(x), part, hw, c, groups, chunks);
  } else {
    allow_smem(adagn_stats<__nv_bfloat16>, smem);
    adagn_stats<__nv_bfloat16><<<grid, ATHREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, hw, c, groups, chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto launch = x_dt == SDM_F32
                    ? (out_dt == SDM_F32 ? &launch_apply<float, float>
                                         : &launch_apply<float, __nv_bfloat16>)
                    : (out_dt == SDM_F32
                           ? &launch_apply<__nv_bfloat16, float>
                           : &launch_apply<__nv_bfloat16, __nv_bfloat16>);
  return (int)launch(x, out, part, gamma, beta, p_dt, s, t, f_dt,
                     f_row_stride, n, hw, c, groups, chunks, eps, stream);
}
