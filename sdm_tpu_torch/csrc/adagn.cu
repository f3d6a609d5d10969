// Fused AdaGN forward: GroupNorm statistics + GN affine + FiLM modulation.
//
// Replaces the TPU kernel sdm_tpu/kernels/adagn.py::fused_adagn
// (_adagn_kernel :32, one whole-sample VMEM tile per grid step, launched at
// :115). On the H100 the work is a reduction followed by one elementwise
// pass, with no matrix work: it is bound by device-memory bytes, x read
// and the output written once each. The TPU kernel reads a sample from HBM
// once because the sample fits its VMEM; no block's shared memory holds a
// sample here (128 KiB to 16 MiB in bf16 against 227 KB).
//
// The route (make_plan; kernels/adagn.py::adagn_plan mirrors it):
//   - bf16 x and output, C % 8 == 0, C % G == 0, C <= ADAGN_MAX_C and
//     G <= 32: adagn_grid, one cooperative launch. Its blocks (one an SM,
//     fewer where a sample has fewer rows than a team would have blocks)
//     form teams, one a sample where the samples in flight fit
//     ADAGN_TEAM_BYTES (fewer, walking several samples each, where they do
//     not). A block streams its rows of a sample through a ring of bulk
//     copies (TMA without a map, one mbarrier a slot) for their
//     statistics, publishes its group partials, meets the team at the
//     sample's counter, merges the team's partials in a fixed order, then
//     reads its rows again, the last read first, while they are in L2, and
//     writes (x - mean) a + h back with bulk stores. One launch instead of
//     two, no statistics pass over x past the L2, and a team's merge of a
//     few partials in place of a prologue over chunks x G of them.
//   - everything else (fp32 x or output, a wider C): two launches,
//     adagn_stats then adagn_apply, over a (chunks, N) grid.
//     The wrapper counts the launches of each route apart.
//
// Statistics, in every kernel: thread (tx, ty) of a block owns the 8
// consecutive channels of 16-byte vector tx and walks rows ty, ty + R, ...
// of its rows, R = ATHREADS / (C / 8) row lanes. It keeps a running
// (count, mean, M2) per channel in fp32: each group of AUNROLL rows' own
// mean and M2 merged in by Chan's formula, Welford's update for the rows
// left over (in the one-pass kernel, per piece of rows), never E[x^2] -
// mean^2, which cancels at large means. The row lanes merge per channel in
// lane order (Chan), then a group's channels (equal counts n: mean_g = mean
// of the mean_c, M2_g = sum M2_c + n sum (mean_c - mean_g)^2); channels
// first, because a group of C/G channels (12 at C = 384) need not align
// with the 8-channel vectors. Blocks' group partials then merge by Chan in
// a fixed order. The output is (x - mean) a + b with a = inv gamma s and
// b = s beta + t, rounded once (centring first: x a' + b' with b' = b -
// mean a would cancel at large means). No float atomics: every merge has a
// fixed order, so a run gives the same bits twice.
//
// The two-pass route: sample n's H*W rows cut into `chunks`
// contiguous row ranges (adagn_chunks: about two blocks per SM over the
// (chunks, N) grid; where C / 8 > ATHREADS, column groups of ATHREADS
// vectors in turn).
//   1. adagn_stats reads x and writes each chunk's (mean, M2) per group to
//      an fp32 (N, chunks, G, 2) scratch.
//   2. adagn_apply's prologue stages sample n's chunks * G partials in
//      shared memory and merges them per group in chunk order (Chan), folds
//      GN affine and FiLM into a and b, then reads x again and writes the
//      output, 16 bytes a load. Its blocks run in the reverse order of the
//      stats pass, so the chunks the stats read last, the likeliest still
//      in L2, are read first.
//
// x is (N, H*W, C) contiguous (an NCHW channels_last activation viewed as
// NHWC); C % 8 == 0 and 16-byte aligned pointers (checked by the wrapper).
#include "async_tiles.cuh"

#define ATHREADS 256   // threads per block of every kernel
#define AUNROLL 4      // rows a thread has in flight (2 and 8 were slower)
#define ASMEM 49152    // dynamic shared memory without the opt-in, bytes
#define AMAX_SMEM 232448  // dynamic shared memory a block may opt into

// The one-pass kernel's settings (tools/torch_adagn_tiles.py builds other
// values with -D to sweep them; the library takes these).
#ifndef ADAGN_PIECE
#define ADAGN_PIECE 65536            // bytes of a bulk copy, most
#endif
#ifndef ADAGN_SLOTS
#define ADAGN_SLOTS 3                // ring slots a block
#endif
#ifndef ADAGN_TEAM_BYTES
#define ADAGN_TEAM_BYTES 67108864    // bytes of the samples in flight
#endif
#define ADAGN_MAX_C 1024       // channels (C / 8 <= ATHREADS / 2)
#define ADAGN_MAX_GROUPS 32    // groups (8 merge lanes a group)
#define ASM_SMEM 233472        // shared memory of an SM
#define ABLOCK_RESERVED 1024   // of it, reserved a resident block

#define ADAGN_TWO_PASS 0
#define ADAGN_ONE_PASS 1

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

// ------------------------------------------------- the one-pass kernel

// The shared memory of a one-pass block past its ring's `data_bytes` (a
// multiple of 16): `nbars` mbarriers, then the statistics' scratch. One
// formula for the plan and the kernel.
struct OnePassSmem {
  int bars, lmean, lm2, cmean, cm2, gpart, gmean, ginv, total;
};

__host__ __device__ __forceinline__ OnePassSmem onepass_smem(int data_bytes,
                                                             int nbars, int c,
                                                             int groups) {
  OnePassSmem s;
  s.bars = data_bytes;
  s.lmean = s.bars + ((nbars * 8 + 15) / 16) * 16;  // [rl][vt][8] lanes
  s.lm2 = s.lmean + ATHREADS * 8 * 4;
  s.cmean = s.lm2 + ATHREADS * 8 * 4;                // [C] channel stats
  s.cm2 = s.cmean + c * 4;
  s.gpart = s.cm2 + c * 4;                           // [G] float2, C even
  s.gmean = s.gpart + groups * 8;                    // [G] the merged mean
  s.ginv = s.gmean + groups * 4;                     // [G] 1 / std
  s.total = s.ginv + groups * 4;
  return s;
}

// A thread's running statistics of its 8 channels: rows seen, mean, M2.
struct Stats8 {
  int k;
  float mean[8], m2[8];
};

// Adds the block's rows first, first + rl, ... below `end` (bf16, row
// stride c; p at the thread's vector in row 0): groups of AUNROLL rows by
// Chan's formula, the rest by Welford's update, as adagn_stats.
__device__ __forceinline__ void stats_rows(Stats8& st, const bf16* p, int c,
                                           int first, int end, int rl) {
  int r = first;
  for (; r + (AUNROLL - 1) * rl < end; r += AUNROLL * rl) {
    float xv[AUNROLL][8];
#pragma unroll
    for (int u = 0; u < AUNROLL; ++u)
      sdm_load8(p + (long long)(r + u * rl) * c, xv[u]);
    const float f = (float)AUNROLL / (float)(st.k + AUNROLL);
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
      const float d = mu - st.mean[e];
      st.mean[e] += d * f;
      st.m2[e] += q + d * d * (float)st.k * f;
    }
    st.k += AUNROLL;
  }
  for (; r < end; r += rl) {
    float xv[8];
    sdm_load8(p + (long long)r * c, xv);
    ++st.k;
    welford8(st.mean, st.m2, xv, 1.f / (float)st.k);
  }
}

// The first of rows [lo, hi) in row lane ty (rows i with i % rl == ty).
__device__ __forceinline__ int lane_first(int lo, int ty, int rl) {
  return lo + ((ty - lo) % rl + rl) % rl;
}

// Rows of `rows` in row lane j.
__device__ __forceinline__ int lane_rows(int j, int rows, int rl) {
  return j < rows ? (rows - j + rl - 1) / rl : 0;
}

// The block's (mean, M2) per group over its `rows` rows into gpart: the row
// lanes merged per channel in lane order (Chan), then each group's
// channels (equal counts). Starts and ends with a block barrier.
__device__ void block_group_stats(const Stats8& st, bool lane_on, int vt,
                                  int rl, int rows, int c, int groups,
                                  unsigned char* smem, const OnePassSmem& L) {
  float* lmean = reinterpret_cast<float*>(smem + L.lmean);
  float* lm2 = reinterpret_cast<float*>(smem + L.lm2);
  float* cmean = reinterpret_cast<float*>(smem + L.cmean);
  float* cm2 = reinterpret_cast<float*>(smem + L.cm2);
  float2* gpart = reinterpret_cast<float2*>(smem + L.gpart);
  const int tid = threadIdx.x;
  __syncthreads();   // the previous sample's scratch is read
  if (lane_on) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lmean[tid * 8 + e] = st.mean[e];
      lm2[tid * 8 + e] = st.m2[e];
    }
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += ATHREADS) {
    float na = 0.f, ma = 0.f, m2a = 0.f;
    for (int j = 0; j < rl; ++j)
      chan_merge(na, ma, m2a, (float)lane_rows(j, rows, rl),
                 lmean[j * vt * 8 + ch], lm2[j * vt * 8 + ch]);
    cmean[ch] = ma;
    cm2[ch] = m2a;
  }
  __syncthreads();
  const int cg = c / groups;
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
    gpart[gi] = make_float2(mg, m2g + (float)rows * dev);
  }
  __syncthreads();
}

// The thread's 8 channels' FiLM folded into the GN affine for sample n,
// which needs no statistics: g = gamma s and h = s beta + t, so that the
// output is (x - mean) a + h with a = inv g.
__device__ __forceinline__ void film_pre(int vc, int n, const void* gamma,
                                         const void* beta, int p_dt,
                                         const void* s, const void* t,
                                         int f_dt, long long f_row_stride,
                                         float g[8], float h[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ch = vc * 8 + e;
    const float sc = sdm_load(s, n * f_row_stride + ch, f_dt);
    g[e] = sdm_load(gamma, ch, p_dt) * sc;
    h[e] = sc * sdm_load(beta, ch, p_dt) + sdm_load(t, n * f_row_stride + ch,
                                                    f_dt);
  }
}

// The thread's 8 channels' group mean and a = inv g, once the statistics
// are merged.
__device__ __forceinline__ void film_post(int vc, int cg, const float* gmean,
                                          const float* ginv, const float g[8],
                                          float mu[8], float a[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int gi = (vc * 8 + e) / cg;
    mu[e] = gmean[gi];
    a[e] = ginv[gi] * g[e];
  }
}

// (x - mu) a + b in place on rows first, first + rl, ... below `end` of
// bf16 rows at p (row stride c; p at the thread's vector in row 0).
__device__ __forceinline__ void apply_rows(bf16* p, int c, int first, int end,
                                           int rl, const float mu[8],
                                           const float a[8],
                                           const float b[8]) {
  int r = first;
  for (; r + (AUNROLL - 1) * rl < end; r += AUNROLL * rl) {
    float xv[AUNROLL][8];
#pragma unroll
    for (int u = 0; u < AUNROLL; ++u)
      sdm_load8(p + (long long)(r + u * rl) * c, xv[u]);
#pragma unroll
    for (int u = 0; u < AUNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[u][e] = (xv[u][e] - mu[e]) * a[e] + b[e];
      sdm_store8(p + (long long)(r + u * rl) * c, xv[u]);
    }
  }
  for (; r < end; r += rl) {
    float xv[8];
    sdm_load8(p + (long long)r * c, xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) xv[e] = (xv[e] - mu[e]) * a[e] + b[e];
    sdm_store8(p + (long long)r * c, xv);
  }
}

// Rows [r0, r0 + rows) of block `i` of `blocks` over hw rows.
__device__ __forceinline__ void share_rows(int i, int blocks, int hw, int& r0,
                                           int& rows) {
  r0 = (int)((long long)i * hw / blocks);
  rows = (int)((long long)(i + 1) * hw / blocks) - r0;
}

// share_rows' count in 32-bit arithmetic, for the merges' loops (the
// plans keep (blocks + 1) hw below 2^31; a 64-bit division is a long
// software routine on the card).
__device__ __forceinline__ int share_count(int i, int blocks, int hw) {
  return (i + 1) * hw / blocks - i * hw / blocks;
}

// Persistent: gridDim.x = `teams` x team_size blocks, all resident (a
// cooperative launch). Team tau walks samples tau, tau + teams, ... (one
// each where N <= teams); its block r takes rows [r hw / team_size,
// (r + 1) hw / team_size) of each, in P pieces of piece_rows rows through
// a ring of ADAGN_SLOTS slots (bulk copies). For a sample it streams its
// pieces (L2 evict_last) for their statistics, publishes its group
// partials to part[sample][r] (N, team_size, G), arrives at the sample's
// counter and waits for the team; it merges the team_size partials (eight
// runs a group, then a fixed tree), departs, then reads its pieces again
// in reverse order, the last read first (L2, evict_first), and writes
// (x - mean) a + h in place and out with bulk stores (evict_first). Entry
// e of a block's walk: sample e / 2P; the statistics of piece e % 2P, or
// past P the apply of piece 2P - 1 - e % 2P. The counters are two 64-bit
// words a sample (cnt[2 sample] arrivals, [2 sample + 1] departures) in a
// buffer the caller zeroes once and keeps: the team's last block to
// depart zeroes its sample's again.
__global__ void __launch_bounds__(ATHREADS, 1)
adagn_grid(const bf16* __restrict__ x, bf16* __restrict__ out,
           unsigned long long* __restrict__ cnt,
           float2* __restrict__ part, const void* __restrict__ gamma,
           const void* __restrict__ beta, int p_dt,
           const void* __restrict__ s, const void* __restrict__ t, int f_dt,
           long long f_row_stride, int n_samples, int hw, int c, int groups,
           int piece_rows, int teams, float eps) {
  constexpr int slots = ADAGN_SLOTS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int slot_elems = piece_rows * c;
  const OnePassSmem L = onepass_smem(slots * slot_elems * 2, slots, c, groups);
  bf16* data = reinterpret_cast<bf16*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* gmean = reinterpret_cast<float*>(smem + L.gmean);
  float* ginv = reinterpret_cast<float*>(smem + L.ginv);
  const float2* gpart = reinterpret_cast<const float2*>(smem + L.gpart);

  const int tid = threadIdx.x;
  const int team_size = gridDim.x / teams;
  const int team = blockIdx.x / team_size, rank = blockIdx.x % team_size;
  const int n_team =
      team < n_samples ? (n_samples - team + teams - 1) / teams : 0;
  int r0, rows;
  share_rows(rank, team_size, hw, r0, rows);
  const int P = (rows + piece_rows - 1) / piece_rows;
  const int total = 2 * n_team * P;
  const uint64_t keep = l2_evict_last(), drop = l2_evict_first();
  // Entry e's sample (of the team's), piece, and whether it applies.
  auto entry = [&](int e, int& j, int& p) {
    j = e / (2 * P);
    const int r = e % (2 * P);
    p = r < P ? r : 2 * P - 1 - r;
    return r >= P;
  };

  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // Thread 0's ring: entries loaded, entries whose slot the block is done
  // with, the entry of the last committed store, and the entries below
  // read_upto whose stores have all read their slots.
  int issued = 0, freed = 0, last_store = -1, read_upto = 0;
  auto refill = [&]() {
    for (; issued < total && issued - slots < freed; ++issued) {
      const int occ = issued - slots;   // the slot's previous entry
      int j, p;
      if (occ >= read_upto && occ <= last_store && entry(occ, j, p)) {
        if (occ < last_store) {
          bulk_wait_read<1>();
          read_upto = last_store;
        } else {
          bulk_wait_read<0>();
          read_upto = last_store + 1;
        }
      }
      const bool apply = entry(issued, j, p);
      const int ns = team + j * teams, lo = p * piece_rows;
      const unsigned bytes = (unsigned)(min(piece_rows, rows - lo) * c * 2);
      uint64_t* bar = &bars[issued % slots];
      mbar_arrive_expect_tx(bar, bytes);
      bulk_load_hint(data + (long long)(issued % slots) * slot_elems,
                     x + ((long long)ns * hw + r0 + lo) * c, bytes, bar,
                     apply ? drop : keep);
    }
  };
  if (tid == 0) refill();

  const int vt = c / 8, rl = ATHREADS / vt;
  const int tx = tid % vt, ty = tid / vt;
  const bool lane_on = ty < rl;
  const int cg = c / groups;
  Stats8 st;
  st.k = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) st.mean[e] = st.m2[e] = 0.f;
  float g[8], h[8], mu[8], a[8];
  for (int e = 0; e < total; ++e) {
    int j, p;
    const bool apply = entry(e, j, p);
    const int ns = team + j * teams;
    const int lo = p * piece_rows, hi = min(rows, lo + piece_rows);
    bf16* slot = data + (long long)(e % slots) * slot_elems;
    float2* pn = part + (long long)ns * team_size * groups;
    unsigned long long* arrived = cnt + 2LL * ns;
    unsigned long long* departed = arrived + 1;
    if (apply && e % (2 * P) == P) {
      // Sample ns: the team's partials, merged, then a = inv g.
      if (lane_on)
        film_pre(tx, ns, gamma, beta, p_dt, s, t, f_dt, f_row_stride, g, h);
      if (tid == 0) wait_counter(arrived, (unsigned long long)team_size);
      __syncthreads();
      const int gi = tid / 8, k8 = tid % 8;
      float na = 0.f, ma = 0.f, m2a = 0.f;
      if (gi < groups) {
        const int b0 = k8 * team_size / 8, b1 = (k8 + 1) * team_size / 8;
        for (int base = b0; base < b1; base += 8) {
          float2 v[8];   // eight loads in flight, then their merges
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (base + u < b1)
              v[u] = __ldcg(&pn[(base + u) * groups + gi]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (base + u < b1)
              chan_merge(na, ma, m2a,
                         (float)share_count(base + u, team_size, hw) *
                             (float)cg,
                         v[u].x, v[u].y);
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {   // lanes k8 with k8 + o, in order
        const float nb2 = __shfl_xor_sync(0xffffffffu, na, o);
        const float mb2 = __shfl_xor_sync(0xffffffffu, ma, o);
        const float m2b2 = __shfl_xor_sync(0xffffffffu, m2a, o);
        if ((k8 & o) == 0) chan_merge(na, ma, m2a, nb2, mb2, m2b2);
      }
      if (gi < groups && k8 == 0) {
        gmean[gi] = ma;
        ginv[gi] = 1.f / sqrtf(m2a / na + eps);
      }
      __syncthreads();   // the partials are read
      if (tid == 0 && atomicAdd(departed, 1ull) ==
                          (unsigned long long)team_size - 1) {
        *arrived = 0;    // the team's last: nobody reads them again
        *departed = 0;
      }
      if (lane_on) film_post(tx, cg, gmean, ginv, g, mu, a);
    }
    mbar_wait(&bars[e % slots], (unsigned)((e / slots) & 1));
    if (!apply) {
      if (lane_on)   // rows of the piece, counted from its first
        stats_rows(st, slot + tx * 8, c, lane_first(lo, ty, rl) - lo,
                   hi - lo, rl);
      if (p == P - 1) {
        // starts and ends with a block barrier: every thread is done with
        // the slot
        block_group_stats(st, lane_on, vt, rl, rows, c, groups, smem, L);
        if (tid < groups) {
          __stcg(&pn[rank * groups + tid], gpart[tid]);
          __threadfence();
        }
        __syncthreads();
        if (tid == 0) atomic_add_release(arrived);
        st.k = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) st.mean[k] = st.m2[k] = 0.f;
      } else {
        __syncthreads();   // every thread is done with the slot
      }
    } else {
      if (lane_on)
        apply_rows(slot + tx * 8, c, lane_first(lo, ty, rl) - lo, hi - lo,
                   rl, mu, a, h);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        bulk_store_hint(out + ((long long)ns * hw + r0 + lo) * c, slot,
                        (unsigned)((hi - lo) * c * 2), drop);
        bulk_commit();
        last_store = e;
      }
    }
    if (tid == 0) {
      freed = e + 1;
      refill();
    }
  }
  if (tid == 0) bulk_wait_read<0>();
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

// Launches the two-pass kernels over a (chunks, N) grid; scratch: (N, chunks,
// G, 2) fp32.
static cudaError_t launch_two_pass(const void* x, void* out, float* scratch,
                                   const void* gamma, const void* beta,
                                   int p_dt, const void* s, const void* t,
                                   int f_dt, long long f_row_stride, int n,
                                   int hw, int c, int groups, int chunks,
                                   float eps, int x_dt, int out_dt,
                                   cudaStream_t stream) {
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto launch = x_dt == SDM_F32
                    ? (out_dt == SDM_F32 ? &launch_apply<float, float>
                                         : &launch_apply<float, __nv_bfloat16>)
                    : (out_dt == SDM_F32
                           ? &launch_apply<__nv_bfloat16, float>
                           : &launch_apply<__nv_bfloat16, __nv_bfloat16>);
  return launch(x, out, part, gamma, beta, p_dt, s, t, f_dt, f_row_stride, n,
                hw, c, groups, chunks, eps, stream);
}

// ------------------------------------------------------------- the plan

// The two passes' row ranges a sample (kernels/adagn.py::adagn_chunks): about
// ACHUNK_WAVES blocks per SM of an H100 over the (chunks, N) grid, at most
// one a row, and at most ACHUNK_PARTIALS partials a sample, which the
// apply stages in 48 KB.
#define ACHUNK_SMS 132
#define ACHUNK_WAVES 2
#define ACHUNK_PARTIALS 4096

static int adagn_chunks(int n, int hw, int groups) {
  int chunks = (ACHUNK_WAVES * ACHUNK_SMS + n - 1) / n;
  chunks = min(chunks, hw);
  chunks = min(chunks, ACHUNK_PARTIALS / groups);
  return max(1, chunks);
}

// A call's route and its launch geometry (kernels/adagn.py::Plan):
// blocks = the grid's blocks; piece_rows = rows a bulk copy, smem =
// dynamic shared memory, teams = teams (one-pass); chunks = row ranges a
// sample (two passes).
struct AdagnPlan {
  int route, blocks, piece_rows, smem, teams, chunks;
};

static bool onepass_ok(int x_dt, int out_dt, int c, int groups) {
  return x_dt == SDM_BF16 && out_dt == SDM_BF16 && groups >= 1 &&
         groups <= ADAGN_MAX_GROUPS && c % 8 == 0 && c % groups == 0 &&
         c <= ADAGN_MAX_C;
}

// sms: the card's SMs. One-pass where onepass_ok and it fits: teams =
// min(N, ADAGN_TEAM_BYTES over a sample's bytes, one at least, the SMs),
// each of min(sms / teams, hw) blocks (a block an SM, a row of a sample a
// block at least); rings of ADAGN_SLOTS pieces of ADAGN_PIECE bytes. Else
// the two passes.
static AdagnPlan make_plan(int n, int hw, int c, int groups, int x_dt,
                           int out_dt, int sms) {
  const int chunks = adagn_chunks(n, hw, groups);
  const AdagnPlan two_pass = {ADAGN_TWO_PASS, chunks * n, 0, 0, 0, chunks};
  if (!onepass_ok(x_dt, out_dt, c, groups)) return two_pass;
  const long long row = 2LL * c;
  const int teams = (int)min((long long)sms,
                             max(1LL, min((long long)n,
                                          ADAGN_TEAM_BYTES / (hw * row))));
  const int team_size = min(sms / max(teams, 1), hw);
  const int piece_rows = max(1, (int)(ADAGN_PIECE / row));
  const int smem = onepass_smem((int)(ADAGN_SLOTS * piece_rows * row),
                                ADAGN_SLOTS, c, groups)
                       .total;
  if (teams < 1 || team_size < 1 ||
      (long long)(team_size + 1) * hw >= (1LL << 31) || smem > AMAX_SMEM ||
      smem + ABLOCK_RESERVED > ASM_SMEM)
    return two_pass;
  return AdagnPlan{ADAGN_ONE_PASS, teams * team_size, piece_rows, smem,
                   teams, 0};
}

// fp32 values of the partials a plan needs: (N, chunks, G, 2) for the two
// passes, (N, team_size, G, 2) for the one pass (which also takes 2 N
// 64-bit counters).
static long long plan_scratch_floats(const AdagnPlan& pl, int n, int groups) {
  if (pl.route == ADAGN_ONE_PASS)
    return 2LL * n * (pl.blocks / pl.teams) * groups;
  return 2LL * n * pl.chunks * groups;
}

static int device_sms() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = sms;
  return sms;
}

// The one-pass launch.
static cudaError_t launch_grid(const AdagnPlan& pl, const void* x, void* out,
                               float* scratch, unsigned long long* counters,
                               const void* gamma, const void* beta, int p_dt,
                               const void* s, const void* t, int f_dt,
                               long long f_row_stride, int n, int hw, int c,
                               int groups, float eps, cudaStream_t stream) {
  cudaFuncSetAttribute(adagn_grid,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  float2* part = reinterpret_cast<float2*>(scratch);
  int piece_rows = pl.piece_rows, teams = pl.teams;
  void* args[] = {&xp, &op, &counters, &part, &gamma, &beta, &p_dt, &s, &t,
                  &f_dt, &f_row_stride, &n, &hw, &c, &groups, &piece_rows,
                  &teams, &eps};
  // Cooperative: every block resident at once, as the counters' waits
  // need.
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(adagn_grid),
                                     dim3(pl.blocks), dim3(ATHREADS), args,
                                     pl.smem, stream);
}

// Launches a plan's route (0 = success, else a cudaError_t).
static int run_plan(const AdagnPlan& pl, const void* x, const void* gamma,
                    const void* beta, const void* s, const void* t, void* out,
                    float* scratch, long long scratch_floats,
                    unsigned long long* counters, long long n_counters, int n,
                    int hw, int c, int groups, float eps,
                    long long f_row_stride, int x_dt, int p_dt, int f_dt,
                    int out_dt, cudaStream_t stream) {
  if (scratch_floats < plan_scratch_floats(pl, n, groups) ||
      (pl.route == ADAGN_ONE_PASS &&
       (counters == nullptr || n_counters < 2LL * n)))
    return (int)cudaErrorInvalidValue;
  if (pl.route == ADAGN_ONE_PASS &&
      (!aligned16(x) || !aligned16(out) ||
       !onepass_ok(x_dt, out_dt, c, groups)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (pl.route == ADAGN_ONE_PASS)
    err = launch_grid(pl, x, out, scratch, counters, gamma, beta, p_dt, s,
                      t, f_dt, f_row_stride, n, hw, c, groups, eps, stream);
  else
    err = launch_two_pass(x, out, scratch, gamma, beta, p_dt, s, t, f_dt,
                          f_row_stride, n, hw, c, groups, pl.chunks, eps,
                          x_dt, out_dt, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static void write_plan(const AdagnPlan& pl, int* plan) {
  const int v[6] = {pl.route, pl.blocks, pl.piece_rows, pl.smem, pl.teams,
                    pl.chunks};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
}

// The plan of a call on a card of `sms` SMs, as the forward takes it:
// plan[0..5] = route (0 two passes, 1 one pass), blocks, piece_rows, smem,
// teams, chunks. Returns 0.
SDM_EXPORT int sdm_adagn_plan(int n, int hw, int c, int groups, int x_dt,
                              int out_dt, int sms, int* plan) {
  write_plan(make_plan(n, hw, c, groups, x_dt, out_dt, sms), plan);
  return 0;
}

// One call: the route make_plan gives on the current card. scratch: the
// plan's fp32 partials (plan_scratch_floats), scratch_floats long;
// counters: the one-pass route's 64-bit counters, n_counters of them (2 N
// at least), zeroed before their first use and kept between calls of a
// stream (kernels/adagn.py keeps them; null for the two passes). Returns
// cudaGetLastError() after the launch (0 = success).
SDM_EXPORT int sdm_adagn_forward(const void* x, const void* gamma,
                                 const void* beta, const void* s,
                                 const void* t, void* out, float* scratch,
                                 long long scratch_floats,
                                 unsigned long long* counters,
                                 long long n_counters, int n, int hw, int c,
                                 int groups, float eps,
                                 long long f_row_stride, int x_dt, int p_dt,
                                 int f_dt, int out_dt, void* stream_ptr) {
  if (n < 1 || hw < 1 || groups < 1 || c % groups != 0)
    return (int)cudaErrorInvalidValue;
  const AdagnPlan pl =
      make_plan(n, hw, c, groups, x_dt, out_dt, device_sms());
  return run_plan(pl, x, gamma, beta, s, t, out, scratch, scratch_floats,
                  counters, n_counters, n, hw, c, groups, eps, f_row_stride,
                  x_dt, p_dt, f_dt, out_dt,
                  static_cast<cudaStream_t>(stream_ptr));
}
