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
// U-Net shape that streams). fp32, and bf16 at other shapes, take CUDA-core
// kernels (fp32 FMA) that mask ragged tiles: keys past S give P = 0, and the
// stats count them as -inf. The apply pass is bound by operations: 4*S*S*D
// per (batch, head) (scores and P V), 2*S*S*D for the stats.
//
// q, k, v and out are (B, S, D) with arbitrary B and S strides and a unit D
// stride, so the attention block can pass views of its qkv buffer; m and l
// are (B, S) fp32. The apply pass writes out in the input dtype, or in fp32
// (the key-axis backward keeps the fp32 output as a residual).
#include "attention_tiles.cuh"

#include <mma.h>

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
//   dK, dQ: one kernel, stream_da, for out_a = scale sum_b round(dA_ab) B_b:
//       the block owns 32 rows a of A (and of A2), streams 64-row tiles b of
//       B and B2, forms the score tile A B^T and the tile A2 B2^T, turns
//       them into dA, rounds it and accumulates dA B. dQ is A = q, A2 = g,
//       B = k, B2 = v; dK is A = k, A2 = v, B = q, B2 = g (the transposed
//       tiles: k_j . q_i is the same score and v_j . g_i the same g_i . v_j).
//
// Each pass is bound by operations: per (batch, head) 4*S*S*D for dV (the
// scores and P^T g) and 6*S*S*D for dK and for dQ (scores, g V^T, dA B).
// dV takes stream_apply_mma where the apply pass does. dK and dQ at bf16,
// S % 64 == 0, D % 128 == 0, D <= 512 (every U-Net shape) run on the
// tensor cores (WMMA 16x16x16, fp32 accumulation) with all four tiles
// resident in shared memory (216 KB at D = 512, one block per SM); fp32, and
// bf16 at other shapes, on the CUDA cores with ragged tiles masked (dA = 0
// outside S). No pipelining and no wgmma yet: later work.
// ---------------------------------------------------------------------------

#define DBM 32                // own rows per dA block
#define DBN 64                // streamed rows per tile
#define PLD (DBN + 8)         // bf16 pitch of the rounded dA tile
#define DMAXD 512             // widest D of the tensor-core dA kernel

static size_t stream_da_wmma_smem_bytes(int D) {
  return 2 * (size_t)DBM * (D + 8) * sizeof(bf16)   // A and A2 tiles
         + 2 * (size_t)DBN * (D + 8) * sizeof(bf16) // B and B2 tiles
         + (size_t)DBM * PLD * sizeof(bf16)         // rounded dA tile
         + 8 * 512 * sizeof(float);                 // per-warp score scratch
}

// Rows [r0, r0 + R) x all D columns of a (rows, D) matrix into dst[R][ld],
// 16 bytes a load (D % 8 == 0, 16-byte aligned rows).
template <int R>
__device__ __forceinline__ void stage_full_rows(bf16* dst, int ld,
                                                const bf16* p, long long ss,
                                                int r0, int D) {
  for (int c = threadIdx.x; c < R * (D / 8); c += blockDim.x) {
    const int r = c / (D / 8), kc = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + kc) =
        *reinterpret_cast<const uint4*>(p + (long long)(r0 + r) * ss + kc);
  }
}

template <bool STAT_COL, typename Pass>
__global__ void __launch_bounds__(256)
stream_da_wmma(const bf16* __restrict__ a, View av, const bf16* __restrict__ a2,
               View a2v, const bf16* __restrict__ bm, View bv,
               const bf16* __restrict__ b2, View b2v, float* __restrict__ o,
               View ov, int S, int D, float scale,
               const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ c_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using namespace nvcuda;
  const int ld = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);       // [DBM][D + 8]
  bf16* A2s = As + DBM * ld;                          // [DBM][D + 8]
  bf16* Bs = A2s + DBM * ld;                          // [DBN][D + 8]
  bf16* B2s = Bs + DBN * ld;                          // [DBN][D + 8]
  bf16* Ps = B2s + DBN * ld;                          // [DBM][PLD]
  float* W = reinterpret_cast<float*>(Ps + DBM * PLD);  // [8][512]

  const int b = blockIdx.y;
  const bf16* ap = slice_ptr(a, av, 1, b);
  const bf16* a2p = slice_ptr(a2, a2v, 1, b);
  const bf16* bp = slice_ptr(bm, bv, 1, b);
  const bf16* b2p = slice_ptr(b2, b2v, 1, b);
  float* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const float* cb = c_in + (long long)b * S;
  const int i0 = blockIdx.x * DBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  // Score tiles: warp (wr, wc) owns rows wr*16.., streamed rows wc*16..;
  // dA B: rows wr*16.., output columns wc*128 .. +128 (D % 128 == 0).
  const bool has_cols = wc * 128 < D;
  float* w = W + warp * 512;

  stage_full_rows<DBM>(As, ld, ap, av.ss, i0, D);
  stage_full_rows<DBM>(A2s, ld, a2p, a2v.ss, i0, D);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int j0 = 0; j0 < S; j0 += DBN) {
    __syncthreads();   // the previous tile's B is consumed
    stage_full_rows<DBN>(Bs, ld, bp, bv.ss, j0, D);
    stage_full_rows<DBN>(B2s, ld, b2p, b2v.ss, j0, D);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc, dacc;
    wmma::fill_fragment(sacc, 0.f);
    wmma::fill_fragment(dacc, 0.f);
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, As + wr * 16 * ld + kk, ld);
      wmma::load_matrix_sync(fb, Bs + wc * 16 * ld + kk, ld);
      wmma::mma_sync(sacc, fa, fb, sacc);
      wmma::load_matrix_sync(fa, A2s + wr * 16 * ld + kk, ld);
      wmma::load_matrix_sync(fb, B2s + wc * 16 * ld + kk, ld);
      wmma::mma_sync(dacc, fa, fb, dacc);
    }
    wmma::store_matrix_sync(w, sacc, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(w + 256, dacc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = wr * 16 + (e >> 4), c = wc * 16 + (e & 15);
      const int si = STAT_COL ? j0 + c : i0 + r;
      const float p = expf(w[e] * scale - mb[si]) / lb[si];
      Ps[r * PLD + c] = __float2bfloat16_rn(p * (w[256 + e] - cb[si]));
    }
    __syncthreads();   // the dA tile is complete
    if (has_cols) {
#pragma unroll
      for (int kk = 0; kk < DBN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + wr * 16 * PLD + kk, PLD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs + kk * ld + wc * 128 + j * 16, ld);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }

  if (!has_cols) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(w, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = i0 + wr * 16 + (e >> 4);
      const int col = wc * 128 + j * 16 + (e & 15);
      op[(long long)row * ov.ss + col] = w[e] * scale;
    }
    __syncwarp();
  }
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
  bool wmma = dt == SDM_BF16 && S % DBN == 0 && D % 128 == 0 && D <= DMAXD &&
              stream_da_wmma_smem_bytes(D) <= MAX_SMEM;
  for (int i = 0; i < 5 && wmma; ++i)
    wmma = aligned16(ptrs[i]) && views[i].sn % 8 == 0 && views[i].ss % 8 == 0;
  if (wmma) {
    const size_t smem = stream_da_wmma_smem_bytes(D);
    auto kernel = stat_col ? &stream_da_wmma<true, Pass>
                           : &stream_da_wmma<false, Pass>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<dim3(S / DBM, batch), 256, smem, stream>>>(
        static_cast<const bf16*>(a), views[0], static_cast<const bf16*>(a2),
        views[1], static_cast<const bf16*>(bm), views[2],
        static_cast<const bf16*>(b2), views[3], o, views[4], S, D, scale, m, l,
        c);
    return (int)cudaGetLastError();
  }
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
