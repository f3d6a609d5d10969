// Tile helpers and the kernels of the streaming attention
// (streaming_attention.cu), some shared with the whole-S attention
// (attention.cu): the softmax statistics (attn_stats, the CUDA-core kernel
// of both) and the mma.sync apply kernel (stream_apply_mma), which the
// streaming backward's dV pass runs. The tensor-core forward kernels are
// on wgmma_tiles.cuh: the whole-S attention's in attention.cu, the
// streaming attention's in streaming_attention.cu.
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
// streaming kernel) as a template argument, so a profiler trace names them
// apart: attn_stats<float, whole_s> is the whole-S attention's fp32 stats
// pass, stream_apply_mma<float, true, dv_pass> the query-axis dV pass.
#pragma once

#include "mma_tiles.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core apply: stream_apply_mma<OutT, QAXIS, Pass>, out[i] = sum_j
// round_bf16(exp(s_ij - m) / l) v_j with the final stats of the stats pass.
//
// Launched with the roles swapped, it replaces the TPU's _dv_kernel
// (sdm_tpu/kernels/streaming_attention.py:133, pallas_call at :298); the
// forward's apply pass runs on stream_apply_wgmma (streaming_attention.cu).
// Bound: operations,
// 4*S*S*D per batch*head (the score tile's q k^T and P V, each 2*S*S*D),
// against bytes of 4*S*D*2 + 8*S: at S = 4096, D = 512 about 1000 operations
// per byte, far above the H100's ~295 for bf16.
//
// Block: 64 own queries, 256 threads (8 warps), one block per SM, grid
// (S/64, B*H, column splits). Split z owns output columns [z d_per_block,
// +d_per_block) and recomputes the full-D scores, so a small grid can still
// fill the card (the streaming passes launch one split). Shared memory at
// D = 512 (205,312 bytes):
//   Q tile   [64][D+8] bf16, loaded once by cp.async, resident;
//   ring     2 stages x (K, V) [32][D+8] bf16: 32-key tiles, tile j+1 in
//            flight (cp.async.cg, 16 bytes a copy) while tile j is computed;
//            V carries only the block's columns; on the query axis each
//            stage also carries its 32 keys' m and l;
//   P tile   [64][40] bf16.
// The 8-element row padding puts the eight 16-byte rows of every ldmatrix
// on distinct banks.
//
// Per 32-key tile, after one cp.async.wait_group + __syncthreads:
//   scores   warp (r = w % 4, h = w / 4) takes rows 16r.., keys 16h.. over
//            all of D: A (Q) by ldmatrix.x4, B (K, stored [key][d], which
//            is B's column-major layout) by plain ldmatrix.x4, two
//            m16n8k16 mma.sync per 16-deep step into fp32 accumulators,
//            even and odd steps in separate accumulators for two
//            independent chains each;
//   P        formed on the accumulator fragment itself (lane L holds rows
//            L/4 and L/4 + 8, columns 2(L%4) and +1): the stats come from
//            the staged tile on the query axis (per key) and from registers
//            on the key axis (per query, loaded once); P = exp(s*scale - m)
//            / l in fp32, rounded to bf16 and written to the P tile as bf16
//            pairs; one __syncthreads;
//   P V      warp (r, h) owns rows 16r.. and half the block's output
//            columns: A (P) by ldmatrix.x4, B (V, stored [key][d]) by
//            ldmatrix.x4.trans, a 16 x 256 fp32 accumulator per warp at
//            most (128 registers a thread).
// The epilogue rounds once to OutT and stores straight from the fragments
// (bf16 or fp32 pairs).
//
// What this design does about the WMMA kernels it replaced (first the
// streaming apply, then the bf16 whole-S apply): they owned 32 queries per
// block (K and V read from L2 S/32 times per batch row; here S/64); their loads
// were synchronous 16-byte copies between barriers (nothing in flight
// during the products; here one tile is always in flight and there are two
// barriers per tile); their scores went through a per-warp fp32 scratch
// with m and l read from global memory per element (here P is formed in
// registers, the stats staged with the tile); the whole-S one kept a 32 x S
// P block in shared memory, and WMMA's opaque fragments forced reloading V
// per 16-column slice (here each V fragment is loaded once per warp and
// used by two products).
// ---------------------------------------------------------------------------

#define MQ 64                 // own queries per block
#define MK 32                 // keys per streamed tile
#define MMAXD 512             // widest D (and widest column split) of the apply
#define MPLD (MK + 8)         // bf16 pitch of its P tile
#define MTHREADS 256

static size_t stream_mma_smem_bytes(int D) {
  return (size_t)MQ * (D + 8) * sizeof(bf16)            // Q tile
         + 2 * 2 * (size_t)MK * (D + 8) * sizeof(bf16)  // ring: K and V
         + (size_t)MQ * MPLD * sizeof(bf16)             // P tile
         + 2 * 2 * MK * sizeof(float);                  // ring: m and l
}

// stream_apply_mma's admission: bf16, S % 64 == 0, D % 128 == 0, D <= 512
// and 16-byte aligned rows of q, k, v and out (strided views of a qkv buffer
// qualify when their strides are multiples of 8 elements).
static bool stream_mma_ok(int dt, const void* const* ptrs, const View* views,
                          int S, int D) {
  return dt == SDM_BF16 && S % MQ == 0 && D % 128 == 0 && D <= MMAXD &&
         stream_mma_smem_bytes(D) <= MAX_SMEM &&
         rows_aligned16(ptrs, views, 4);
}

// The apply's parts (pv_tile is also the streaming backward's dA B). Warp
// (wr, wh) of the apply, lane (g = lane / 4, tg = lane % 4).
//
// P = exp(s * scale - m) / l on the warp's 16 x 16 score fragment (rows
// 16 wr.., keys 16 wh..; s[0] + s[1] are the even and odd 16-deep steps),
// rounded to bf16 into the P tile [MQ][MPLD]. Query axis: the tile's key
// stats, st[0, MK) = m and st[MK, 2 MK) = l; key axis: this lane's rows'.
template <bool QAXIS>
__device__ __forceinline__ void form_p(bf16* Ps, const float (&s)[2][2][4],
                                       const float* st, const float (&mrow)[2],
                                       const float (&lrow)[2], float scale,
                                       int wr, int wh, int g, int tg) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = wh * 16 + n * 8 + 2 * tg;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float pr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sv = s[0][n][2 * hh + e] + s[1][n][2 * hh + e];
        const float mm = QAXIS ? st[col + e] : mrow[hh];
        const float ll = QAXIS ? st[MK + col + e] : lrow[hh];
        pr[e] = expf(sv * scale - mm) / ll;
      }
      store_pair(Ps + (wr * 16 + g + 8 * hh) * MPLD + col, pr[0], pr[1]);
    }
  }
}

// acc += P V over one KT-key tile: A (P) by ldmatrix.x4 at `pa`, B (V,
// stored [key][d] with pitch ldv) by ldmatrix.x4.trans at `vb`, wcols
// output columns (a multiple of 16, at most 8 NT). The streaming backward's
// dA B is the same product (dA for P, the streamed rows B for V).
template <int KT = MK, int NT>
__device__ __forceinline__ void pv_tile(float (&acc)[NT][4], unsigned pa,
                                        unsigned vb, int ldv, int wcols) {
#pragma unroll
  for (int kk = 0; kk < KT; kk += 16) {
    unsigned a[4];
    ldsm_x4(a, pa + kk * 2);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np * 16 < wcols) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vb + (kk * ldv + np * 16) * 2);
        mma_bf16(acc[2 * np], a, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }
}

// The epilogue: one rounding to OutT, stored straight from the fragments
// (rows row0 + g and + 8, columns cbase + 8 n + 2 tg).
template <typename OutT, int NT>
__device__ __forceinline__ void store_acc(OutT* op, long long ss,
                                          const float (&acc)[NT][4],
                                          int row0, int cbase, int wcols,
                                          int tg) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n * 8 < wcols) {
      const int col = cbase + n * 8 + 2 * tg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store_pair(op + (long long)(row0 + 8 * hh) * ss + col,
                   acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

template <typename OutT, bool QAXIS, typename Pass>
__global__ void __launch_bounds__(MTHREADS, 1)
stream_apply_mma(const bf16* __restrict__ q, View qv,
                 const bf16* __restrict__ k, View kv,
                 const bf16* __restrict__ v, View vv, OutT* __restrict__ o,
                 View ov, int heads, int S, int D, int d_per_block,
                 float scale, const float* __restrict__ m_in,
                 const float* __restrict__ l_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);           // [MQ][ld]
  bf16* Ring = Qs + MQ * ld;                              // [2][K, V][MK][ld]
  bf16* Ps = Ring + 4 * MK * ld;                          // [MQ][MPLD]
  float* St = reinterpret_cast<float*>(Ps + MQ * MPLD);   // [2][m, l][MK]

  const int b = blockIdx.y;
  const bf16* qp = slice_ptr(q, qv, heads, b);
  const bf16* kp = slice_ptr(k, kv, heads, b);
  const bf16* vp = slice_ptr(v, vv, heads, b);
  OutT* op = slice_ptr(o, ov, heads, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const int i0 = blockIdx.x * MQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wh = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  const int c0 = blockIdx.z * d_per_block;      // the block's columns
  const int dcols = min(D - c0, d_per_block);
  const int wcols = dcols / 2;                  // P V output columns per warp
  const int cbase = c0 + wh * wcols;

  // The Q tile joins the first cp.async group, with key tile 0.
  cp_async_rows(Qs, ld, qp + (long long)i0 * qv.ss, qv.ss, MQ, D / 8, tid,
                MTHREADS);
  // Key tile at j0 into ring stage `st`: K in full, V's block columns.
  auto load_tile = [&](int j0, int st) {
    bf16* Ks = Ring + st * 2 * MK * ld;
    cp_async_rows(Ks, ld, kp + (long long)j0 * kv.ss, kv.ss, MK, D / 8, tid,
                  MTHREADS);
    cp_async_rows(Ks + MK * ld + c0, ld, vp + (long long)j0 * vv.ss + c0,
                  vv.ss, MK, dcols / 8, tid, MTHREADS);
    if (QAXIS && tid < 2 * MK)
      cp_async4(smem_u32(St + st * 2 * MK + tid),
                tid < MK ? mb + j0 + tid : lb + j0 + tid - MK);
  };

  // Key axis: the stats of this lane's two rows, for the whole key loop.
  float mrow[2] = {0.f, 0.f}, lrow[2] = {1.f, 1.f};
  if (!QAXIS) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i0 + wr * 16 + g + 8 * hh;
      mrow[hh] = mb[row];
      lrow[hh] = lb[row];
    }
  }

  // ldmatrix lane addresses (bytes, shared window). A fragments (Q, P):
  // lanes 0-15 rows 0-15 at column 0, lanes 16-31 rows 0-15 at column 8.
  // B of the scores (K rows are keys): lanes 0-7 keys 0-7 / d 0, 8-15 keys
  // 0-7 / d 8, 16-23 keys 8-15 / d 0, 24-31 keys 8-15 / d 8, so registers
  // 0-1 are key block 0's fragment and 2-3 key block 1's. B of P V (V rows
  // are keys, transposed load): lanes 0-15 keys 0-15 at column 0, 16-31 at
  // column 8, so registers 0-1 are column block 0 and 2-3 column block 1.
  const unsigned qa = smem_u32(Qs + (wr * 16 + (lane & 15)) * ld +
                               (lane >> 4) * 8);
  const unsigned pa = smem_u32(Ps + (wr * 16 + (lane & 15)) * MPLD +
                               (lane >> 4) * 8);
  const int kb_off = (wh * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = (lane & 15) * ld + cbase + (lane >> 4) * 8;

  float acc[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = S / MK;
  load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();
    // Tile t (and Q) visible to every warp; every warp is done with tile
    // t - 1, so its stage and the P tile may be overwritten.
    __syncthreads();
    if (t + 1 < ntiles) load_tile((t + 1) * MK, st ^ 1);
    cp_async_commit();

    const bf16* Ks = Ring + st * 2 * MK * ld;
    const unsigned kb = smem_u32(Ks + kb_off);
    const unsigned vb = smem_u32(Ks + MK * ld + vb_off);

    float s[2][2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[p][n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 32) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned a[4], bk[4];
        ldsm_x4(a, qa + (kk + 16 * p) * 2);
        ldsm_x4(bk, kb + (kk + 16 * p) * 2);
        mma_bf16(s[p][0], a, bk[0], bk[1]);
        mma_bf16(s[p][1], a, bk[2], bk[3]);
      }
    }

    form_p<QAXIS>(Ps, s, St + st * 2 * MK, mrow, lrow, scale, wr, wh, g, tg);
    __syncthreads();   // the P tile is complete
    pv_tile(acc, pa, vb, ld, wcols);
  }
  store_acc(op, ov.ss, acc, i0 + wr * 16 + g, cbase, wcols, tg);
}

// Launch stream_apply_mma: grid (S/64, bh, split), each split d_per_block
// output columns (a multiple of 128, at most MMAXD).
template <typename Pass, typename OutT>
static cudaError_t launch_apply_mma(const bf16* q, const bf16* k,
                                    const bf16* v, OutT* o, const View* views,
                                    int bh, int heads, int S, int D,
                                    int split, int d_per_block, float scale,
                                    int axis_q, const float* m,
                                    const float* l, cudaStream_t stream) {
  const size_t smem = stream_mma_smem_bytes(D);
  auto kernel = axis_q ? &stream_apply_mma<OutT, true, Pass>
                       : &stream_apply_mma<OutT, false, Pass>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / MQ, bh, split), MTHREADS, smem, stream>>>(
      q, views[0], k, views[1], v, views[2], o, views[3], heads, S, D,
      d_per_block, scale, m, l);
  return cudaGetLastError();
}
