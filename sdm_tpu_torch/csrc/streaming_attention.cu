// Streaming (two-pass) self-attention, forward and backward, softmax over the
// query axis ("q", the reference's parity quirk) or the key axis ("k").
//
// Replaces the TPU kernels of sdm_tpu/kernels/streaming_attention.py: the
// forward's stats pass (_stats_kernel, pallas_call at :223) and apply pass
// (_apply_kernel, pallas_call at :234), and the backward's dV pass
// (_dv_kernel, pallas_call at :298), dK pass (_dk_kernel, :260) and dQ pass
// (_dq_kernel, :271); the backward is described further down. Both stream
// (256, 256) tiles through VMEM so no S x S score block exists. On the H100
// the whole-S kernel (attention.cu) takes bf16 tensor-core grids up to
// S = 3200 (WHOLE_S_MAX_MMA) and fp32 up to S = 1687, where its CUDA-core
// 32 x S block stops fitting (S = 4096 is the 256x256 SR model's layer-2
// grid). This kernel never holds more than one score tile, and its shared
// memory does not depend on S:
//
//   1. stats, grid (S/64 kept rows, B): the shared kernels of
//      attention_tiles.cuh (column stats for "q", row stats for "k"), which
//      loop over the reduced axis tile by tile.
//   2. apply: each block owns a tile of queries and walks all key tiles.
//      For each it computes the score tile with the full-D contraction,
//      turns it into P = exp(s - m) / l with the final stats (no online
//      rescaling: the stats pass is complete), rounds P to v's dtype, and
//      accumulates P V_j for its output columns in fp32 registers. One
//      rounding to the output type at the end.
//
// bf16 at S % 64 == 0, D % 128 == 0 with 16-byte aligned rows runs on the
// tensor cores through mma.sync with ldmatrix fragments and cp.async rings
// (attention_tiles.cuh, shared with the whole-S kernel): the stats pass on
// attn_stats_mma (D <= 1152), the apply pass (and the dV pass, which is the
// apply pass with the roles swapped) on stream_apply_mma (D <= 512; every
// U-Net shape that streams), and the backward's dK and dQ passes on
// stream_da_mma (S % DA_ROWS == 0, D <= 512; below). fp32, and bf16 at
// other shapes, take CUDA-core kernels (fp32 FMA) that mask ragged tiles:
// keys past S give P = 0, and the stats count them as -inf. The apply pass is bound by operations: 4*S*S*D
// per (batch, head) (scores and P V), 2*S*S*D for the stats.
//
// q, k, v and out are (B, S, D) with arbitrary B and S strides and a unit D
// stride, so the attention block can pass views of its qkv buffer; m and l
// are (B, S) fp32. The apply pass writes out in the input dtype, or in fp32
// (the key-axis backward keeps the fp32 output as a residual).
#include "attention_tiles.cuh"

// Pass tags, so a profiler trace names the apply kernel's callers apart
// (stream_apply_mma<float, false, dv_pass> is the dV pass) and dK from dQ.
struct apply_pass {};
struct dv_pass {};
struct dk_pass {};
struct dq_pass {};

// CUDA-core apply.
#define TQ 32                 // queries per block
#define TK 64                 // keys per score tile
#define TDC 512               // output columns per block
#define VK 16                 // value rows staged per step

template <typename T, typename OutT, bool QAXIS, typename Pass>
__global__ void __launch_bounds__(256)
stream_apply(const T* __restrict__ q, View qv, const T* __restrict__ k,
             View kv, const T* __restrict__ v, View vv, OutT* __restrict__ o,
             View ov, int S, int D, float scale,
             const float* __restrict__ m_in, const float* __restrict__ l_in) {
  // Q and K chunks while scoring, value rows during P V.
  __shared__ float stage[VK * TDC];
  __shared__ float Ps[TQ * (TK + 1)];
  float* Qs = stage;                     // [BK][TQ + 1]
  float* Ks = stage + BK * (TQ + 1);     // [BK][TK + 1]
  float* Vs = stage;                     // [VK][TDC]

  const int b = blockIdx.y;
  const T* qp = slice_ptr(q, qv, 1, b);
  const T* kp = slice_ptr(k, kv, 1, b);
  const T* vp = slice_ptr(v, vv, 1, b);
  OutT* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const int i0 = blockIdx.x * TQ;
  const int dbeg = blockIdx.z * TDC;
  const int dend = min(D, dbeg + TDC);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // Rows ty and ty + 16, output columns dbeg + tx + 16 * c.
  float acc[2][TDC / 16] = {};
  for (int j0 = 0; j0 < S; j0 += TK) {
    float s[2][4] = {};
    for (int d0 = 0; d0 < D; d0 += BK) {
      load_tile_t<T, TQ>(Qs, TQ + 1, qp, qv.ss, i0, S, d0, D);
      load_tile_t<T, TK>(Ks, TK + 1, kp, kv.ss, j0, S, d0, D);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[2], bv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) av[i] = Qs[kk * (TQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Ks[kk * (TK + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
    // P, rounded to the value type; zero for keys (or queries) past S.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float p = 0.f;
        if (i0 + r < S && j0 + c < S) {
          const int si = QAXIS ? j0 + c : i0 + r;
          p = sdm_round<T>(expf(s[i][j] * scale - mb[si]) / lb[si]);
        }
        Ps[r * (TK + 1) + c] = p;
      }
    for (int jj0 = 0; jj0 < TK; jj0 += VK) {
      for (int e = threadIdx.x; e < VK * TDC; e += blockDim.x) {
        const int r = e / TDC, c = e - r * TDC;
        float val = 0.f;
        if (j0 + jj0 + r < S && dbeg + c < dend)
          val = sdm_to_float(vp[(long long)(j0 + jj0 + r) * vv.ss + dbeg + c]);
        Vs[e] = val;
      }
      __syncthreads();   // value rows staged; P visible to every thread
#pragma unroll 4
      for (int jj = 0; jj < VK; ++jj) {
        const float p0 = Ps[ty * (TK + 1) + jj0 + jj];
        const float p1 = Ps[(ty + 16) * (TK + 1) + jj0 + jj];
#pragma unroll
        for (int c = 0; c < TDC / 16; ++c) {
          const float vj = Vs[jj * TDC + tx + 16 * c];
          acc[0][c] += p0 * vj;
          acc[1][c] += p1 * vj;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < TDC / 16; ++c) {
      const int col = dbeg + tx + 16 * c;
      if (col < dend)
        op[(long long)row * ov.ss + col] = sdm_from_float<OutT>(acc[i][c]);
    }
  }
}

static void read_views(const long long* strides, View* views, int n) {
  for (int i = 0; i < n; ++i)
    views[i] = View{strides[2 * i], 0, strides[2 * i + 1]};
}

// strides: (sb, ss) of q and k in elements. m, l: (B, S) fp32 each.
// Returns cudaGetLastError() after the launch (0 = success).
SDM_EXPORT int sdm_streaming_stats(const void* q, const void* k, float* m,
                                   float* l, const long long* strides,
                                   int batch, int S, int D, float scale,
                                   int axis_q, int dt, void* stream_ptr) {
  View views[2];
  read_views(strides, views, 2);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* ptrs[2] = {q, k};
  if (stats_mma_ok(dt, ptrs, views, S, D))
    return (int)launch_stats_mma<streaming>(
        static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
        views[1], batch, 1, S, D, scale, axis_q, m, l, stream);
  if (dt == SDM_F32)
    return (int)launch_stats<streaming, float>(
        static_cast<const float*>(q), views[0], static_cast<const float*>(k),
        views[1], batch, 1, S, D, scale, axis_q, m, l, stream);
  return (int)launch_stats<streaming, bf16>(
      static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
      views[1], batch, 1, S, D, scale, axis_q, m, l, stream);
}

// The apply kernel for out[i] = sum_j round_v(P_ij) v_j with P from (q, k,
// m, l) on `axis_q`, the output in OutT. The dV pass calls it with the roles
// swapped (see sdm_streaming_dv).
template <typename Pass, typename OutT>
static int launch_apply(const void* q, const void* k, const void* v, OutT* o,
                        const View* views, int batch, int S, int D,
                        float scale, int axis_q, const float* m,
                        const float* l, int dt, cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, o};
  if (stream_mma_ok(dt, ptrs, views, S, D))
    return (int)launch_apply_mma<Pass>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), o, views, batch, 1, S, D, 1, D, scale,
        axis_q, m, l, stream);
  const dim3 grid((S + TQ - 1) / TQ, batch, (D + TDC - 1) / TDC);
  if (dt == SDM_F32) {
    auto kernel = axis_q ? &stream_apply<float, OutT, true, Pass>
                         : &stream_apply<float, OutT, false, Pass>;
    kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(q), views[0], static_cast<const float*>(k),
        views[1], static_cast<const float*>(v), views[2], o, views[3], S, D,
        scale, m, l);
  } else {
    auto kernel = axis_q ? &stream_apply<bf16, OutT, true, Pass>
                         : &stream_apply<bf16, OutT, false, Pass>;
    kernel<<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
        views[1], static_cast<const bf16*>(v), views[2], o, views[3], S, D,
        scale, m, l);
  }
  return (int)cudaGetLastError();
}

// The admissions, for the Python mirrors in kernels/streaming_attention.py
// (checked against these on the card). ptrs and strides as the entry points
// take them: q, k (stats) or q, k, v, out (apply). stream_mma_smem_bytes and
// stats_mma_smem_bytes are the kernels' dynamic shared memory.
SDM_EXPORT int sdm_streaming_stats_takes_mma(const void* const* ptrs,
                                             const long long* strides, int S,
                                             int D, int dt) {
  View views[2];
  read_views(strides, views, 2);
  return stats_mma_ok(dt, ptrs, views, S, D);
}

SDM_EXPORT int sdm_streaming_apply_takes_mma(const void* const* ptrs,
                                             const long long* strides, int S,
                                             int D, int dt) {
  View views[4];
  read_views(strides, views, 4);
  return stream_mma_ok(dt, ptrs, views, S, D);
}

SDM_EXPORT int sdm_streaming_mma_smem_bytes(int D) {
  return (int)stream_mma_smem_bytes(D);
}

SDM_EXPORT int sdm_stats_mma_smem_bytes(int D) {
  return (int)stats_mma_smem_bytes(D);
}

// strides: (sb, ss) of q, k, v and out in elements. m, l: the stats pass's
// (B, S) fp32 outputs for the same axis. out is written in out_dt (the input
// dtype, or fp32).
SDM_EXPORT int sdm_streaming_apply(const void* q, const void* k, const void* v,
                                   void* o, const float* m, const float* l,
                                   const long long* strides, int batch, int S,
                                   int D, float scale, int axis_q, int dt,
                                   int out_dt, void* stream_ptr) {
  View views[4];
  read_views(strides, views, 4);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (out_dt == SDM_F32)
    return launch_apply<apply_pass>(q, k, v, static_cast<float*>(o), views,
                                    batch, S, D, scale, axis_q, m, l, dt,
                                    stream);
  return launch_apply<apply_pass>(q, k, v, static_cast<bf16*>(o), views, batch,
                                  S, D, scale, axis_q, m, l, dt, stream);
}

// ---------------------------------------------------------------------------
// Backward. With P_ij = exp(s_ij - m) / l recomputed tile by tile from the
// forward's stats (per key j on the q axis, per query i on the k axis) and g
// the output gradient in the input dtype:
//
//   dV_j = sum_i round(P_ij) g_i                      (sdm_streaming_dv)
//   dA_ij = P_ij (g_i . v_j - corr)                   (corr indexed as m, l)
//   dK_j = scale sum_i round(dA_ij) q_i               (sdm_streaming_dk)
//   dQ_i = scale sum_j round(dA_ij) k_j               (sdm_streaming_dq)
//
// round() is the rounding to the input dtype the TPU kernels apply before
// each product (:135, :156, :171); every sum is fp32 and every output fp32
// (B, S, D). corr is the caller's (B, S) fp32 softmax-Jacobian term: c_j =
// dV_j . v_j on the q axis, D_i = g_i . out_i on the k axis.
//
// On the TPU a grid's inner axis walks the reduced tiles in order and
// accumulates into the resident output block. Here each block owns its
// output rows and loops over the other axis itself, so no atomics and no
// second pass are needed:
//
//   dV: the apply kernel with the roles swapped. Its "query" rows are the
//       keys (the block owns 64 of them on the tensor cores, 32 on the CUDA
//       cores), its "keys" the queries, its values g, and the stats travel
//       with the other index: sum_i P^T_ji g_i is the apply pass's sum over
//       the streamed rows. Output in fp32.
//   dK, dQ: one kernel for out_a = scale sum_b round(dA_ab) B_b: the block
//       owns rows a of A (and of A2), streams tiles of rows b of B and B2,
//       forms the score tile A B^T and the tile A2 B2^T, turns them into dA,
//       rounds it and accumulates dA B. dQ is A = q, A2 = g, B = k, B2 = v;
//       dK is A = k, A2 = v, B = q, B2 = g (the transposed tiles: k_j . q_i
//       is the same score and v_j . g_i the same g_i . v_j).
//
// Each pass is bound by operations: per (batch, head) 4*S*S*D for dV (the
// scores and P^T g) and 6*S*S*D for dK and for dQ (scores, g V^T, dA B).
// dV takes stream_apply_mma where the apply pass does, dK and dQ take
// stream_da_mma (below) where da_mma_ok admits them; fp32, and bf16 at other
// shapes, run stream_da on the CUDA cores with ragged tiles masked (dA = 0
// outside S).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Tensor-core dA pass: stream_da_mma<STAT_COL, Pass, BM, BN, KSPLIT>.
//
// Replaces the TPU's _dk_kernel (sdm_tpu/kernels/streaming_attention.py:152,
// pallas_call at :260) and _dq_kernel (:167, pallas_call at :271) for bf16
// at S % DA_ROWS == 0, D % 128 == 0, D <= 512 with 16-byte aligned rows of
// all five tensors: every U-Net shape that streams. Bound: operations,
// 6*S*S*D per batch row (A B^T, A2 B2^T and dA B, 2*S*S*D each), against
// 4*S*D*2 bytes in and 4*S*D out: at S = 4096, D = 512 about 1,500
// operations per byte, far above the H100's ~295 for bf16.
//
// Block: BM own rows, 256 threads (8 warps), one block per SM, grid
// (S/BM, B). Shared memory (211,328 bytes at D = 512 and the launched
// tiling, BM = 64, BN = 16, KSPLIT = 2):
//   A, A2    [BM][D+8] bf16 each, loaded once by cp.async, resident;
//   ring     2 stages x (B, B2) [BN][D+8] bf16: tile b+1 in flight
//            (cp.async.cg, 16 bytes a copy) while tile b is computed; with
//            STAT_COL (the stats index the streamed rows: dQ on the query
//            axis, dK on the key axis) each stage also carries its rows' m,
//            l and corr; otherwise each lane holds its own rows' in registers
//            for the whole loop;
//   dA tile  [BM][BN+8] bf16;
//   exchange 8 KB of fp32 partial scores (KSPLIT = 2 only).
// stream_apply_mma's 64 resident rows with 2 stages of 32-row tiles would
// take 266,240 bytes for the two operand pairs, past MAX_SMEM. Two tilings
// fit: 32 own rows with 32-row tiles (B and B2 read from L2 S/32 times per
// batch row), or 64 with 16-row tiles (S/64 times, twice the barriers per
// streamed row). Both are instantiations (BM, BN). On an H100 SXM (700 W,
// tools/torch_da_tiles.py, 16 x 4096 x 512 bf16) 64 own rows on two D
// halves took 5.41-5.76 ms a pass, 64 over all of D 5.87-6.11, 32 on two
// halves 6.25-6.28, 32 over all of D 6.78-7.01; the launched tiling is the
// first.
//
// Per streamed tile, after one cp.async.wait_group + __syncthreads:
//   scores   warp (wr, wc, kh) takes own rows 16 wr.., streamed rows
//            WN wc.. (WN = 8 or 16) and the kh-th of KSPLIT slices of D.
//            S = A B^T and dP = A2 B2^T in two fp32 accumulator sets, even
//            and odd 16-deep steps apart for independent chains: A and A2 by
//            ldmatrix.x4, B and B2 (stored [row][d], which is B's
//            column-major layout) by plain ldmatrix.x4, m16n8k16 mma.sync;
//   halves   KSPLIT = 2: the two warps of one (wr, wc) tile each pass the
//            partial sums of the rows they do not finish (8 floats a lane)
//            to the other through the exchange; one __syncthreads;
//   dA       formed on the accumulator fragments (lane L holds rows L/4 and
//            L/4 + 8, columns 2(L%4) and +1): p = exp(s scale - m) / l and
//            p (dp - corr) in fp32, rounded to bf16 and stored as pairs into
//            the dA tile; one __syncthreads;
//   dA B     warp (wr, wo) owns rows 16 wr.. and D / (8 / (BM/16)) output
//            columns: A (dA) by ldmatrix.x4, B by ldmatrix.x4.trans
//            (pv_tile), an fp32 accumulator of 16 x 128 (BM = 32) or
//            16 x 256 (BM = 64) per warp.
// The epilogue multiplies by scale and stores fp32 pairs from the fragments.
//
// KSPLIT = 2 gives each score warp a 16 x 16 tile of both S and dP, one
// ldmatrix.x4 of shared memory per mma; a 16 x 8 tile over all of D
// (KSPLIT = 1) needs 1.5, and the scores are two thirds of the products.
// It costs the exchange and a third barrier per tile.
//
// What this design does about the tensor-core kernel it replaced: that
// kernel owned 32 rows and staged 64-row tiles of B and B2 with synchronous
// 16-byte copies between two barriers (nothing in flight during the
// products; here one tile is always in flight); its score tiles went
// through a per-warp fp32 scratch, where 32 lanes each took 8 exponentials
// in series with m, l and corr read from global memory per element (here dA
// is formed in registers, the stats staged with the tile or held in
// registers); its 16 x 16 x 16 fragment API loaded each B fragment once per
// 16-column slice of dA B and used it once (here one ldmatrix.x4.trans
// feeds two products).
// ---------------------------------------------------------------------------

#define DA_THREADS 256
#define DA_MAXD 512           // widest D of stream_da_mma
// The tiling the dK and dQ passes launch: own rows per block, streamed rows
// per ring stage, D slices per score tile.
#define DA_BM 64
#define DA_BN 16
#define DA_KSPLIT 2
#define DA_ROWS (DA_BM > DA_BN ? DA_BM : DA_BN)   // S must be a multiple

template <int BM, int BN, int KSPLIT>
static size_t da_mma_smem_bytes(int D) {
  return 2 * (size_t)BM * (D + 8) * sizeof(bf16)        // A and A2 tiles
         + 2 * 2 * (size_t)BN * (D + 8) * sizeof(bf16)  // ring: B and B2
         + (size_t)BM * (BN + 8) * sizeof(bf16)         // rounded dA tile
         + 2 * 3 * BN * sizeof(float)                   // ring: m, l, corr
         + (KSPLIT - 1) * 8 * 8 * 32 * sizeof(float);   // partial scores
}

// stream_da_mma's admission: bf16, S % DA_ROWS == 0, D % 128 == 0,
// D <= 512, the shared memory within MAX_SMEM and 16-byte aligned rows of
// A, A2, B, B2 and out.
static bool da_mma_ok(int dt, const void* const* ptrs, const View* views,
                      int S, int D) {
  return dt == SDM_BF16 && S % DA_ROWS == 0 && D % 128 == 0 &&
         D <= DA_MAXD &&
         da_mma_smem_bytes<DA_BM, DA_BN, DA_KSPLIT>(D) <= MAX_SMEM &&
         rows_aligned16(ptrs, views, 5);
}

template <bool STAT_COL, typename Pass, int BM, int BN, int KSPLIT>
__global__ void __launch_bounds__(DA_THREADS, 1)
stream_da_mma(const bf16* __restrict__ a, View av, const bf16* __restrict__ a2,
              View a2v, const bf16* __restrict__ bm, View bv,
              const bf16* __restrict__ b2, View b2v, float* __restrict__ o,
              View ov, int S, int D, float scale,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              const float* __restrict__ c_in) {
  constexpr int WR = BM / 16;              // row groups, both phases
  constexpr int TILES = 8 / KSPLIT;        // score tiles of 16 rows x WN
  constexpr int WNC = TILES / WR;          // their column groups
  constexpr int WN = BN / WNC;             // streamed rows per score tile
  constexpr int NB = WN / 8;               // its 8-row mma blocks
  constexpr int OC = 8 / WR;               // dA B output column groups
  constexpr int NT = DA_MAXD / OC / 8;     // accumulator blocks per warp
  constexpr int DLD = BN + 8;              // bf16 pitch of the dA tile
  static_assert(WR * WNC * KSPLIT == 8 && (WN == 8 || WN == 16) &&
                (KSPLIT == 1 || KSPLIT == 2), "stream_da_mma tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);          // [BM][ld]
  bf16* A2s = As + BM * ld;                              // [BM][ld]
  bf16* Ring = A2s + BM * ld;                            // [2][B, B2][BN][ld]
  bf16* Ds = Ring + 4 * BN * ld;                         // [BM][DLD]
  float* St = reinterpret_cast<float*>(Ds + BM * DLD);   // [2][m, l, c][BN]
  float* X = St + 2 * 3 * BN;                            // [8][4 NB][32]

  const int b = blockIdx.y;
  const bf16* ap = slice_ptr(a, av, 1, b);
  const bf16* a2p = slice_ptr(a2, a2v, 1, b);
  const bf16* bp = slice_ptr(bm, bv, 1, b);
  const bf16* b2p = slice_ptr(b2, b2v, 1, b);
  float* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const float* cb = c_in + (long long)b * S;
  const int i0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp % WR;                 // own rows 16 wr .. +16
  const int wc = (warp / WR) % WNC;         // score columns WN wc .. +WN
  const int kh = warp / TILES;              // score D slice
  const int kspan = D / KSPLIT;
  const int wcols = D / OC;                 // dA B output columns per warp
  const int cbase = (warp / WR) * wcols;

  // The own rows join the first cp.async group, with streamed tile 0.
  cp_async_rows(As, ld, ap + (long long)i0 * av.ss, av.ss, BM, D / 8, tid,
                DA_THREADS);
  cp_async_rows(A2s, ld, a2p + (long long)i0 * a2v.ss, a2v.ss, BM, D / 8,
                tid, DA_THREADS);
  // Streamed tile at j0 into ring stage `st`: B, B2 and (STAT_COL) the
  // rows' m, l and corr.
  auto load_tile = [&](int j0, int st) {
    bf16* Bs = Ring + st * 2 * BN * ld;
    cp_async_rows(Bs, ld, bp + (long long)j0 * bv.ss, bv.ss, BN, D / 8, tid,
                  DA_THREADS);
    cp_async_rows(Bs + BN * ld, ld, b2p + (long long)j0 * b2v.ss, b2v.ss, BN,
                  D / 8, tid, DA_THREADS);
    if (STAT_COL && tid < 3 * BN) {
      const float* src = tid < BN ? mb : tid < 2 * BN ? lb : cb;
      cp_async4(smem_u32(St + st * 3 * BN + tid), src + j0 + tid % BN);
    }
  };

  // Own-row stats: those of this lane's two rows, for the whole loop.
  float mrow[2] = {0.f, 0.f}, lrow[2] = {1.f, 1.f}, crow[2] = {0.f, 0.f};
  if (!STAT_COL) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i0 + wr * 16 + g + 8 * hh;
      mrow[hh] = mb[row];
      lrow[hh] = lb[row];
      crow[hh] = cb[row];
    }
  }

  // ldmatrix lane addresses (bytes, shared window). A fragments (A, A2, dA):
  // lanes 0-15 rows 0-15 at column 0, lanes 16-31 rows 0-15 at column 8. B
  // of the scores, WN = 16: lanes 0-7 rows 0-7 / d 0, 8-15 rows 0-7 / d 8,
  // 16-23 rows 8-15 / d 0, 24-31 rows 8-15 / d 8, so registers 0-1 are row
  // block 0's fragment and 2-3 row block 1's; WN = 8: lanes 8i .. 8i+7 rows
  // 0-7 at d 8i, so registers 0-1 are one 16-deep step's fragment and 2-3
  // the next one's. B of dA B (transposed): lanes 0-15 rows 0-15 at column
  // 0, 16-31 at column 8, so registers 0-1 are column block 0, 2-3 block 1.
  const unsigned aa = smem_u32(As + (wr * 16 + (lane & 15)) * ld +
                               (lane >> 4) * 8 + kh * kspan);
  const unsigned a2a = aa + BM * ld * 2;
  const unsigned da = smem_u32(Ds + (wr * 16 + (lane & 15)) * DLD +
                               (lane >> 4) * 8);
  const int kb_off =
      (WN == 16 ? (wc * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                      ((lane >> 3) & 1) * 8
                : (wc * 8 + (lane & 7)) * ld + (lane >> 3) * 8) +
      kh * kspan;
  const int vb_off = (lane & 15) * ld + cbase + (lane >> 4) * 8;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = S / BN;
  load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();
    // Tile t (and A, A2) visible to every warp; every warp is done with
    // tile t - 1, so its stage, the dA tile and the exchange may be
    // overwritten.
    __syncthreads();
    if (t + 1 < ntiles) load_tile((t + 1) * BN, st ^ 1);
    cp_async_commit();

    const bf16* Bs = Ring + st * 2 * BN * ld;
    const unsigned kb = smem_u32(Bs + kb_off);
    const unsigned kb2 = kb + BN * ld * 2;

    float s[2][NB][4], dp[2][NB][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[p][n][e] = dp[p][n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kspan; kk += 32) {
      if constexpr (WN == 16) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          unsigned x[4], y[4];
          ldsm_x4(x, aa + (kk + 16 * p) * 2);
          ldsm_x4(y, kb + (kk + 16 * p) * 2);
          mma_bf16(s[p][0], x, y[0], y[1]);
          mma_bf16(s[p][1], x, y[2], y[3]);
          ldsm_x4(x, a2a + (kk + 16 * p) * 2);
          ldsm_x4(y, kb2 + (kk + 16 * p) * 2);
          mma_bf16(dp[p][0], x, y[0], y[1]);
          mma_bf16(dp[p][1], x, y[2], y[3]);
        }
      } else {
        unsigned y[4], y2[4];
        ldsm_x4(y, kb + kk * 2);
        ldsm_x4(y2, kb2 + kk * 2);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          unsigned x[4];
          ldsm_x4(x, aa + (kk + 16 * p) * 2);
          mma_bf16(s[p][0], x, y[2 * p], y[2 * p + 1]);
          ldsm_x4(x, a2a + (kk + 16 * p) * 2);
          mma_bf16(dp[p][0], x, y2[2 * p], y2[2 * p + 1]);
        }
      }
    }
    // This lane's scores: rows 16 wr + g + 8 hh, streamed columns
    // WN wc + 8 n + 2 tg + e, at [n][2 hh + e].
    float sv[NB][4], dv[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[n][e] = s[0][n][e] + s[1][n][e];
        dv[n][e] = dp[0][n][e] + dp[1][n][e];
      }
    if constexpr (KSPLIT == 2) {
      // Warp kh finishes rows hh = kh and passes its partial sums of rows
      // hh = 1 - kh to the warp of the other D half (warp ^ TILES).
      float* xw = X + warp * 4 * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (hh != kh) {
              xw[(4 * n + 2 * e) * 32] = sv[n][2 * hh + e];
              xw[(4 * n + 2 * e + 1) * 32] = dv[n][2 * hh + e];
            }
      __syncthreads();
      const float* xr = X + (warp ^ TILES) * 4 * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (hh == kh) {
              sv[n][2 * hh + e] += xr[(4 * n + 2 * e) * 32];
              dv[n][2 * hh + e] += xr[(4 * n + 2 * e + 1) * 32];
            }
    }
    // dA = p (dp - corr), rounded to bf16 into the dA tile.
    const float* stt = St + st * 3 * BN;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = wc * WN + n * 8 + 2 * tg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (KSPLIT == 2 && hh != kh) continue;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mm = STAT_COL ? stt[col + e] : mrow[hh];
          const float ll = STAT_COL ? stt[BN + col + e] : lrow[hh];
          const float cc = STAT_COL ? stt[2 * BN + col + e] : crow[hh];
          const float p = expf(sv[n][2 * hh + e] * scale - mm) / ll;
          x[e] = p * (dv[n][2 * hh + e] - cc);
        }
        store_pair(Ds + (wr * 16 + g + 8 * hh) * DLD + col, x[0], x[1]);
      }
    }
    __syncthreads();   // the dA tile is complete
    pv_tile<BN>(acc, da, smem_u32(Bs + vb_off), ld, wcols);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= scale;
  store_acc(op, ov.ss, acc, i0 + wr * 16 + g, cbase, wcols, tg);
}

// Launch stream_da_mma<..., BM, BN, KSPLIT>: grid (S/BM, batch). views: A,
// A2, B, B2, out.
template <typename Pass, int BM, int BN, int KSPLIT>
static cudaError_t launch_da_mma(const bf16* a, const bf16* a2,
                                 const bf16* bm, const bf16* b2, float* o,
                                 const View* views, int batch, int S, int D,
                                 float scale, bool stat_col, const float* m,
                                 const float* l, const float* c,
                                 cudaStream_t stream) {
  const size_t smem = da_mma_smem_bytes<BM, BN, KSPLIT>(D);
  auto kernel = stat_col ? &stream_da_mma<true, Pass, BM, BN, KSPLIT>
                         : &stream_da_mma<false, Pass, BM, BN, KSPLIT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / BM, batch), DA_THREADS, smem, stream>>>(
      a, views[0], a2, views[1], bm, views[2], b2, views[3], o, views[4], S,
      D, scale, m, l, c);
  return cudaGetLastError();
}

template <typename T, bool STAT_COL, typename Pass>
__global__ void __launch_bounds__(256)
stream_da(const T* __restrict__ a, View av, const T* __restrict__ a2,
          View a2v, const T* __restrict__ bm, View bv,
          const T* __restrict__ b2, View b2v, float* __restrict__ o, View ov,
          int S, int D, float scale, const float* __restrict__ m_in,
          const float* __restrict__ l_in, const float* __restrict__ c_in) {
  // A and B chunks while scoring, B rows during dA B.
  __shared__ float stage[VK * TDC];
  __shared__ float Ps[TQ * (TK + 1)];
  float* As = stage;                     // [BK][TQ + 1]
  float* Bs = stage + BK * (TQ + 1);     // [BK][TK + 1]
  float* Vs = stage;                     // [VK][TDC]

  const int b = blockIdx.y;
  const T* ap = slice_ptr(a, av, 1, b);
  const T* a2p = slice_ptr(a2, a2v, 1, b);
  const T* bp = slice_ptr(bm, bv, 1, b);
  const T* b2p = slice_ptr(b2, b2v, 1, b);
  float* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const float* cb = c_in + (long long)b * S;
  const int i0 = blockIdx.x * TQ;
  const int dbeg = blockIdx.z * TDC;
  const int dend = min(D, dbeg + TDC);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // Rows ty and ty + 16, output columns dbeg + tx + 16 * c.
  float acc[2][TDC / 16] = {};
  for (int j0 = 0; j0 < S; j0 += TK) {
    float s[2][4] = {}, dp[2][4] = {};
    for (int pass = 0; pass < 2; ++pass) {
      const T* lhs = pass ? a2p : ap;
      const T* rhs = pass ? b2p : bp;
      const long long lss = pass ? a2v.ss : av.ss;
      const long long rss = pass ? b2v.ss : bv.ss;
      for (int d0 = 0; d0 < D; d0 += BK) {
        load_tile_t<T, TQ>(As, TQ + 1, lhs, lss, i0, S, d0, D);
        load_tile_t<T, TK>(Bs, TK + 1, rhs, rss, j0, S, d0, D);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          float x[2], y[4];
#pragma unroll
          for (int i = 0; i < 2; ++i) x[i] = As[kk * (TQ + 1) + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) y[j] = Bs[kk * (TK + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (pass) dp[i][j] += x[i] * y[j];
              else s[i][j] += x[i] * y[j];
            }
        }
        __syncthreads();
      }
    }
    // dA, rounded to the input type; zero outside S.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float da = 0.f;
        if (i0 + r < S && j0 + c < S) {
          const int si = STAT_COL ? j0 + c : i0 + r;
          const float p = expf(s[i][j] * scale - mb[si]) / lb[si];
          da = sdm_round<T>(p * (dp[i][j] - cb[si]));
        }
        Ps[r * (TK + 1) + c] = da;
      }
    for (int jj0 = 0; jj0 < TK; jj0 += VK) {
      for (int e = threadIdx.x; e < VK * TDC; e += blockDim.x) {
        const int r = e / TDC, c = e - r * TDC;
        float val = 0.f;
        if (j0 + jj0 + r < S && dbeg + c < dend)
          val = sdm_to_float(bp[(long long)(j0 + jj0 + r) * bv.ss + dbeg + c]);
        Vs[e] = val;
      }
      __syncthreads();   // B rows staged; dA visible to every thread
#pragma unroll 4
      for (int jj = 0; jj < VK; ++jj) {
        const float p0 = Ps[ty * (TK + 1) + jj0 + jj];
        const float p1 = Ps[(ty + 16) * (TK + 1) + jj0 + jj];
#pragma unroll
        for (int c = 0; c < TDC / 16; ++c) {
          const float vj = Vs[jj * TDC + tx + 16 * c];
          acc[0][c] += p0 * vj;
          acc[1][c] += p1 * vj;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < TDC / 16; ++c) {
      const int col = dbeg + tx + 16 * c;
      if (col < dend) op[(long long)row * ov.ss + col] = acc[i][c] * scale;
    }
  }
}

// out = scale * sum_b round(dA_ab) B_b for rows a of A; see the comment
// above. views: A, A2, B, B2, out.
template <typename Pass>
static int launch_da(const void* a, const void* a2, const void* bm,
                     const void* b2, float* o, const View* views, int batch,
                     int S, int D, float scale, bool stat_col, const float* m,
                     const float* l, const float* c, int dt,
                     cudaStream_t stream) {
  const void* ptrs[5] = {a, a2, bm, b2, o};
  if (da_mma_ok(dt, ptrs, views, S, D))
    return (int)launch_da_mma<Pass, DA_BM, DA_BN, DA_KSPLIT>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(a2),
        static_cast<const bf16*>(bm), static_cast<const bf16*>(b2), o, views,
        batch, S, D, scale, stat_col, m, l, c, stream);
  const dim3 grid((S + TQ - 1) / TQ, batch, (D + TDC - 1) / TDC);
  if (dt == SDM_F32) {
    auto kernel = stat_col ? &stream_da<float, true, Pass>
                           : &stream_da<float, false, Pass>;
    kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(a), views[0], static_cast<const float*>(a2),
        views[1], static_cast<const float*>(bm), views[2],
        static_cast<const float*>(b2), views[3], o, views[4], S, D, scale, m,
        l, c);
  } else {
    auto kernel = stat_col ? &stream_da<bf16, true, Pass>
                           : &stream_da<bf16, false, Pass>;
    kernel<<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(a), views[0], static_cast<const bf16*>(a2),
        views[1], static_cast<const bf16*>(bm), views[2],
        static_cast<const bf16*>(b2), views[3], o, views[4], S, D, scale, m,
        l, c);
  }
  return (int)cudaGetLastError();
}

// stream_da_mma's admission and dynamic shared memory, for the Python
// mirrors (checked against these on the card). ptrs and strides: A, A2, B,
// B2 and out (any order: each tensor is checked alone).
SDM_EXPORT int sdm_streaming_da_takes_mma(const void* const* ptrs,
                                          const long long* strides, int S,
                                          int D, int dt) {
  View views[5];
  read_views(strides, views, 5);
  return da_mma_ok(dt, ptrs, views, S, D);
}

SDM_EXPORT int sdm_streaming_da_smem_bytes(int D) {
  return (int)da_mma_smem_bytes<DA_BM, DA_BN, DA_KSPLIT>(D);
}

// dV = sum_i round(P_ij) g_i, fp32 (B, S, D). strides: (sb, ss) of q, k, g
// and dv in elements; m, l the forward's stats for the same axis.
SDM_EXPORT int sdm_streaming_dv(const void* q, const void* k, const void* g,
                                float* dv, const float* m, const float* l,
                                const long long* strides, int batch, int S,
                                int D, float scale, int axis_q, int dt,
                                void* stream_ptr) {
  View in[4], views[4];
  read_views(strides, in, 4);
  // The apply kernel's (q, k, v, out) are (k, q, g, dv): its own rows are
  // the keys, so the stats travel with its rows on the q axis.
  views[0] = in[1];
  views[1] = in[0];
  views[2] = in[2];
  views[3] = in[3];
  return launch_apply<dv_pass>(k, q, g, dv, views, batch, S, D, scale,
                               !axis_q, m, l, dt,
                               static_cast<cudaStream_t>(stream_ptr));
}

// dK = scale sum_i round(dA_ij) q_i, fp32 (B, S, D). strides: (sb, ss) of
// q, k, v, g and dk; corr (B, S) fp32.
SDM_EXPORT int sdm_streaming_dk(const void* q, const void* k, const void* v,
                                const void* g, float* dk, const float* m,
                                const float* l, const float* corr,
                                const long long* strides, int batch, int S,
                                int D, float scale, int axis_q, int dt,
                                void* stream_ptr) {
  View in[5], views[5];
  read_views(strides, in, 5);
  views[0] = in[1];   // A = k
  views[1] = in[2];   // A2 = v
  views[2] = in[0];   // B = q
  views[3] = in[3];   // B2 = g
  views[4] = in[4];
  return launch_da<dk_pass>(k, v, q, g, dk, views, batch, S, D, scale,
                            !axis_q, m, l, corr, dt,
                            static_cast<cudaStream_t>(stream_ptr));
}

// dQ = scale sum_j round(dA_ij) k_j, fp32 (B, S, D). strides: (sb, ss) of
// q, k, v, g and dq; corr (B, S) fp32.
SDM_EXPORT int sdm_streaming_dq(const void* q, const void* k, const void* v,
                                const void* g, float* dq, const float* m,
                                const float* l, const float* corr,
                                const long long* strides, int batch, int S,
                                int D, float scale, int axis_q, int dt,
                                void* stream_ptr) {
  View in[5], views[5];
  read_views(strides, in, 5);
  views[0] = in[0];   // A = q
  views[1] = in[3];   // A2 = g
  views[2] = in[1];   // B = k
  views[3] = in[2];   // B2 = v
  views[4] = in[4];
  return launch_da<dq_pass>(q, g, k, v, dq, views, batch, S, D, scale, axis_q,
                            m, l, corr, dt,
                            static_cast<cudaStream_t>(stream_ptr));
}
