// Self-attention forward with the softmax over the query axis ("q", the
// reference's parity quirk) or the key axis ("k", standard attention).
//
// Replaces the TPU kernel sdm_tpu/kernels/attention.py::fused_attention
// (_attn_kernel :43: one whole S x S score tile per (batch*head) in VMEM,
// pallas_call at :86). On the H100 a block has at most 227 KB of shared
// memory and blocks run in no order, and the head dimension here is the
// channel width (D = 512 or 1024), so both axes run two passes:
//
//   1. stats, grid (S/64 kept rows, B*H): per kept row the max m and the sum
//      l = sum exp(s - m) over ALL reduced rows, merged online tile by tile
//      (a block loops over the reduced tiles), to an fp32 scratch. On the q
//      axis the kept rows are the keys (column stats) and no output row can
//      be written before these exist; on the k axis they are the queries.
//   2. apply: each block owns a tile of queries and walks all key tiles,
//      turns each score tile into P = exp(s - m) / l with the final stats of
//      the column (q) or the row (k), rounds P to the value type (the
//      reference's P.astype(v.dtype)) and accumulates P V in fp32.
//
// bf16 inputs at S % 64 == 0, D % 128 == 0, D <= 1024 with 16-byte aligned
// rows (every U-Net shape) run on the tensor cores through mma.sync with
// ldmatrix fragments and cp.async rings: the stats on attn_stats_mma and
// the apply on stream_apply_mma (D <= 512; both in attention_tiles.cuh,
// shared with the streaming kernel) or attn_apply_mma_wide (512 < D <=
// 1024, below), each split over output columns so that a small grid still
// fills the card. fp32 inputs, and bf16 at other shapes, take the SIMT
// kernels (fp32 FMA on the CUDA cores; the apply keeps a 32 x S fp32 score
// block). The score and P V products bound the kernel (4*S*S*D operations
// per head, plus the stats pass's 2*S*S*D).
//
// The entry point returns SDM_ERR_TOKENS, launching nothing, past the
// longest S it takes: on the CUDA cores where the 32 x S block stops fitting
// in shared memory (S > 1687), on the tensor cores past WHOLE_S_MAX_MMA
// (sdm_attention_fits says beforehand; longer grids take the streaming
// kernel, streaming_attention.cu).
//
// q, k, v and out are (N, S, H, D) with arbitrary N/S/H strides and a unit
// D stride, so the attention block can pass q/k/v as views of its qkv buffer.
#include "attention_tiles.cuh"

#define ABM 32     // query rows per apply block
#define ABN 64     // keys per score tile in the apply block
#define ADT 128    // output columns per P V pass

// Returned (instead of a CUDA error code, all >= 0) when S is too long for
// the apply pass's shared memory.
#define SDM_ERR_TOKENS (-1)

template <typename T, bool QAXIS>
__global__ void __launch_bounds__(256)
attn_apply(const T* __restrict__ q, View qv, const T* __restrict__ k, View kv,
           const T* __restrict__ v, View vv, T* __restrict__ o, View ov,
           int heads, int S, int D, int d_per_block, float scale,
           const float* __restrict__ m_in, const float* __restrict__ l_in) {
  extern __shared__ float smem[];
  const int ldp = S + 1;
  float* P = smem;                          // [ABM][S + 1] scores, then P
  float* stage = smem + ABM * ldp;          // 4096 floats, reused per phase
  float* Qs = stage;                        // [BK][ABM + 1]
  float* Ks = stage + BK * (ABM + 1);       // [BK][ABN + 1]
  float* Vs = stage;                        // [32][ADT]

  const int b = blockIdx.y;
  const T* qp = slice_ptr(q, qv, heads, b);
  const T* kp = slice_ptr(k, kv, heads, b);
  const T* vp = slice_ptr(v, vv, heads, b);
  T* op = o + (long long)(b / heads) * ov.sn + (long long)(b % heads) * ov.sh;
  const int i0 = blockIdx.x * ABM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // Phase 1: scaled scores of this block's query rows against all keys.
  for (int j0 = 0; j0 < S; j0 += ABN) {
    float acc[2][4] = {};
    for (int d0 = 0; d0 < D; d0 += BK) {
      load_tile_t<T, ABM>(Qs, ABM + 1, qp, qv.ss, i0, S, d0, D);
      load_tile_t<T, ABN>(Ks, ABN + 1, kp, kv.ss, j0, S, d0, D);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[2], bv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) av[i] = Qs[kk * (ABM + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Ks[kk * (ABN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tx + 16 * j;
        if (col < S) P[(ty + 16 * i) * ldp + col] = acc[i][j] * scale;
      }
  }
  __syncthreads();

  // Softmax -> P, rounded to the value type; rows past S are zero.
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  for (int e = threadIdx.x; e < ABM * S; e += blockDim.x) {
    const int r = e / S, j = e - r * S;
    float* pe = P + r * ldp + j;
    const int si = QAXIS ? j : i0 + r;
    *pe = i0 + r < S ? sdm_round<T>(expf(*pe - mb[si]) / lb[si]) : 0.f;
  }
  __syncthreads();

  // Phase 2: out[i0:i0+32, dcols] = P V, fp32 accumulation.
  const int dbeg = blockIdx.z * d_per_block;
  const int dend = min(D, dbeg + d_per_block);
  for (int c0 = dbeg; c0 < dend; c0 += ADT) {
    float acc[2][8] = {};
    for (int j0 = 0; j0 < S; j0 += 32) {
      for (int e = threadIdx.x; e < 32 * ADT; e += blockDim.x) {
        const int r = e / ADT, c = e - r * ADT;
        float val = 0.f;
        if (j0 + r < S && c0 + c < dend)
          val = sdm_to_float(vp[(long long)(j0 + r) * vv.ss + c0 + c]);
        Vs[r * ADT + c] = val;
      }
      __syncthreads();
      const int jn = min(32, S - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float p0 = P[ty * ldp + j0 + jj];
        const float p1 = P[(ty + 16) * ldp + j0 + jj];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float vj = Vs[jj * ADT + tx + 16 * j];
          acc[0][j] += p0 * vj;
          acc[1][j] += p1 * vj;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i0 + ty + 16 * i;
      if (row >= S) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < dend)
          op[(long long)row * ov.ss + col] = sdm_from_float<T>(acc[i][j]);
      }
    }
  }
}

static size_t apply_smem_bytes(int S) {
  return (size_t)(ABM * (S + 1) + 4096) * sizeof(float);
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core path.
//
// WHOLE_S_MAX_MMA: the longest S the tensor-core path takes whole (3200,
// the bound the shared memory of the former WMMA apply's 32 x S P block set,
// kept as a constant). Its kernels do not depend on S, but the route does:
// the whole-S path's backward is the plain recompute with an S x S softmax
// (sdm_tpu's VJP, attention.py:193), while past this S the streaming kernel
// runs its own backward kernels, so moving the limit would change the SR
// trainer's memory and kernels. kernels/attention.py mirrors it.
// ---------------------------------------------------------------------------

#define WHOLE_S_MAX_MMA 3200

// ---------------------------------------------------------------------------
// Wide tensor-core apply: attn_apply_mma_wide<QAXIS>, for 512 < D <= 1024.
//
// Replaces, with stream_apply_mma, the apply half of the TPU's _attn_kernel
// (sdm_tpu/kernels/attention.py:43, pallas_call at :86) at the U-Net's
// D = 1024 blocks. Bound: operations, 4*S*S*D per batch*head, as
// stream_apply_mma. The same design (64 own queries, 8 warps, mma.sync on
// ldmatrix fragments, P formed on the score fragments), but full-width Q, K
// and V tiles do not fit together at D = 1024 (Q [64][1032] bf16 alone is
// 132,096 bytes, a 32-key K or V stage 66,048), so:
//   - the block owns at most 512 output columns (a split of at least two);
//   - the score phase streams K in 128-column chunks through its own ring;
//   - V carries only the block's columns.
// Shared memory at D = 1024 (230,400 of 232,448 bytes, one block per SM):
//   Q        [64][D+8] bf16 resident                       132,096
//   K ring   3 x [32][136] bf16 (32 keys x 128 columns)    26,112
//   V ring   2 x [32][520] bf16 (32 keys x the columns)    66,560
//   P tile   [64][40] bf16                                  5,120
//   stats    2 x (m, l) [32] fp32 (query axis)                512
// Per 32-key tile the block takes D/128 K steps and one V step, each one
// cp.async group, two steps in flight (wait_group 1, one barrier a step):
// a K step adds the chunk's products to the score fragments and the last
// one forms P; the V step runs P V into the 16 x (columns / 2) fp32
// accumulator of each warp.
// ---------------------------------------------------------------------------

#define XKC 128                // K columns per chunk
#define XKLD (XKC + 8)         // bf16 pitch of a K chunk
#define XVLD (MMAXD + 8)       // bf16 pitch of a V stage (at most 512 columns)

static size_t wide_smem_bytes(int D) {
  return (size_t)MQ * (D + 8) * sizeof(bf16)          // Q tile
         + 3 * (size_t)MK * XKLD * sizeof(bf16)        // K ring
         + 2 * (size_t)MK * XVLD * sizeof(bf16)        // V ring
         + (size_t)MQ * MPLD * sizeof(bf16)            // P tile
         + 2 * 2 * MK * sizeof(float);                 // stats ring
}

template <bool QAXIS>
__global__ void __launch_bounds__(MTHREADS, 1)
attn_apply_mma_wide(const bf16* __restrict__ q, View qv,
                    const bf16* __restrict__ k, View kv,
                    const bf16* __restrict__ v, View vv, bf16* __restrict__ o,
                    View ov, int heads, int S, int D, int d_per_block,
                    float scale, const float* __restrict__ m_in,
                    const float* __restrict__ l_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);           // [MQ][ld]
  bf16* Kr = Qs + MQ * ld;                                // [3][MK][XKLD]
  bf16* Vr = Kr + 3 * MK * XKLD;                          // [2][MK][XVLD]
  bf16* Ps = Vr + 2 * MK * XVLD;                          // [MQ][MPLD]
  float* St = reinterpret_cast<float*>(Ps + MQ * MPLD);   // [2][m, l][MK]

  const int b = blockIdx.y;
  const bf16* qp = slice_ptr(q, qv, heads, b);
  const bf16* kp = slice_ptr(k, kv, heads, b);
  const bf16* vp = slice_ptr(v, vv, heads, b);
  bf16* op = slice_ptr(o, ov, heads, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const int i0 = blockIdx.x * MQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wh = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  const int c0 = blockIdx.z * d_per_block;
  const int dcols = min(D - c0, d_per_block);
  const int wcols = dcols / 2;
  const int nk = D / XKC;              // K steps per key tile
  const int per_tile = nk + 1;         // and one V step
  const int nsteps = (S / MK) * per_tile;

  cp_async_rows(Qs, ld, qp + (long long)i0 * qv.ss, qv.ss, MQ, D / 8, tid,
                MTHREADS);
  // Step i: key tile t = i / per_tile; part p < nk is K chunk p (the
  // (t*nk + p)-th K step, ring stage (t*nk + p) % 3, with the tile's stats
  // at p = 0 on the query axis), p == nk the V tile (stage t % 2).
  auto load_step = [&](int i) {
    const int t = i / per_tile, p = i - t * per_tile;
    const int j0 = t * MK;
    if (p < nk) {
      cp_async_rows(Kr + ((t * nk + p) % 3) * MK * XKLD, XKLD,
                    kp + (long long)j0 * kv.ss + p * XKC, kv.ss, MK, XKC / 8,
                    tid, MTHREADS);
      if (QAXIS && p == 0 && tid < 2 * MK)
        cp_async4(smem_u32(St + (t & 1) * 2 * MK + tid),
                  tid < MK ? mb + j0 + tid : lb + j0 + tid - MK);
    } else {
      cp_async_rows(Vr + (t & 1) * MK * XVLD, XVLD,
                    vp + (long long)j0 * vv.ss + c0, vv.ss, MK, dcols / 8,
                    tid, MTHREADS);
    }
  };
  load_step(0);
  cp_async_commit();
  load_step(1);
  cp_async_commit();

  float mrow[2] = {0.f, 0.f}, lrow[2] = {1.f, 1.f};
  if (!QAXIS) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i0 + wr * 16 + g + 8 * hh;
      mrow[hh] = mb[row];
      lrow[hh] = lb[row];
    }
  }

  // ldmatrix lane addresses, as in stream_apply_mma.
  const unsigned qa = smem_u32(Qs + (wr * 16 + (lane & 15)) * ld +
                               (lane >> 4) * 8);
  const unsigned pa = smem_u32(Ps + (wr * 16 + (lane & 15)) * MPLD +
                               (lane >> 4) * 8);
  const int kb_off = (wh * 16 + (lane & 7) + ((lane >> 4) << 3)) * XKLD +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = (lane & 15) * XVLD + wh * wcols + (lane >> 4) * 8;

  float acc[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[2][2][4];

  for (int i = 0; i < nsteps; ++i) {
    const int t = i / per_tile, p = i - t * per_tile;
    cp_async_wait<1>();
    // Step i visible to every warp; every warp is done with step i - 1
    // (and with the P tile of tile t - 1 before tile t's last K step).
    __syncthreads();
    if (i + 2 < nsteps) load_step(i + 2);
    cp_async_commit();

    if (p < nk) {
      if (p == 0) {
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[pp][n][e] = 0.f;
      }
      const unsigned kb = smem_u32(Kr + ((t * nk + p) % 3) * MK * XKLD +
                                   kb_off);
      const unsigned qc = qa + p * XKC * 2;
#pragma unroll
      for (int kk = 0; kk < XKC; kk += 32) {
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          unsigned a[4], bk[4];
          ldsm_x4(a, qc + (kk + 16 * pp) * 2);
          ldsm_x4(bk, kb + (kk + 16 * pp) * 2);
          mma_bf16(s[pp][0], a, bk[0], bk[1]);
          mma_bf16(s[pp][1], a, bk[2], bk[3]);
        }
      }
      if (p == nk - 1)   // the scores are complete: P into the P tile
        form_p<QAXIS>(Ps, s, St + (t & 1) * 2 * MK, mrow, lrow, scale, wr,
                      wh, g, tg);
    } else {   // P V (the P tile was published by this step's barrier)
      pv_tile(acc, pa, smem_u32(Vr + (t & 1) * MK * XVLD + vb_off), XVLD,
              wcols);
    }
  }
  store_acc(op, ov.ss, acc, i0 + wr * 16 + g, c0 + wh * wcols, wcols, tg);
}

// The tensor-core path's admission: bf16, S % 64 == 0, D % 128 == 0, the
// apply's shared memory within MAX_SMEM (stream_apply_mma to D = 512,
// attn_apply_mma_wide to D = 1024) and 16-byte aligned rows of q, k, v and
// out. The stats kernel then admits the same inputs (D <= 1152).
static bool mma_ok(int dt, const void* const* ptrs, const View* views, int S,
                   int D) {
  return dt == SDM_BF16 && S % MQ == 0 && D % 128 == 0 &&
         (D <= MMAXD ? stream_mma_smem_bytes(D) : wide_smem_bytes(D)) <=
             MAX_SMEM &&
         rows_aligned16(ptrs, views, 4);
}

// Output-column split so a small grid still fills the card: about
// `target` blocks, each split a multiple of `cols` columns and at most
// max_cols (each split recomputes the scores).
static void split_columns(int blocks, int D, int cols, int target,
                          int max_cols, int* split, int* d_per_block) {
  const int chunks = (D + cols - 1) / cols;
  const int min_s = (D + max_cols - 1) / max_cols;
  int s = (target + blocks - 1) / blocks;
  s = s > chunks ? chunks : s;
  s = s < min_s ? min_s : s;
  *d_per_block = ((chunks + s - 1) / s) * cols;
  *split = (D + *d_per_block - 1) / *d_per_block;
}

// The tensor-core apply's plan: about one wave of blocks on the 132 SMs (one
// block per SM), splits of at most MMAXD columns; wide: 1 for
// attn_apply_mma_wide (D > MMAXD).
static void mma_plan(int bh, int S, int D, int* wide, int* split,
                     int* d_per_block) {
  *wide = D > MMAXD;
  split_columns(bh * (S / MQ), D, 128, 132, MMAXD, split, d_per_block);
}

static int launch_mma(const bf16* qp, const bf16* kp, const bf16* vp,
                      bf16* out, float* m, float* l, const View* views,
                      int bh, int heads, int S, int D, float scale,
                      int axis_q, cudaStream_t stream) {
  cudaError_t err = launch_stats_mma<whole_s>(
      qp, views[0], kp, views[1], bh, heads, S, D, scale, axis_q, m, l, stream);
  if (err != cudaSuccess) return (int)err;
  int wide, split, d_per_block;
  mma_plan(bh, S, D, &wide, &split, &d_per_block);
  if (!wide)
    return (int)launch_apply_mma<whole_s>(qp, kp, vp, out, views, bh, heads,
                                          S, D, split, d_per_block, scale,
                                          axis_q, m, l, stream);
  const size_t smem = wide_smem_bytes(D);
  auto kernel = axis_q ? &attn_apply_mma_wide<true>
                       : &attn_apply_mma_wide<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / MQ, bh, split), MTHREADS, smem, stream>>>(
      qp, views[0], kp, views[1], vp, views[2], out, views[3], heads, S, D,
      d_per_block, scale, m, l);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* qp, const T* kp, const T* vp, T* out, float* m,
                  float* l, const View* views, int bh, int heads, int S, int D,
                  float scale, int axis_q, cudaStream_t stream) {
  cudaError_t err = launch_stats<whole_s, T>(
      qp, views[0], kp, views[1], bh, heads, S, D, scale, axis_q, m, l, stream);
  if (err != cudaSuccess) return (int)err;
  int split, d_per_block;
  split_columns(bh * ((S + ABM - 1) / ABM), D, ADT, 2 * 132, D, &split,
                &d_per_block);
  const dim3 grid((S + ABM - 1) / ABM, bh, split);
  const size_t smem = apply_smem_bytes(S);
  auto kernel = axis_q ? &attn_apply<T, true> : &attn_apply<T, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<grid, 256, smem, stream>>>(qp, views[0], kp, views[1], vp,
                                      views[2], out, views[3], heads, S, D,
                                      d_per_block, scale, m, l);
  return (int)cudaGetLastError();
}

static void read_views(const long long* strides, View* views, int n) {
  for (int i = 0; i < n; ++i)
    views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// strides: 12 int64 values, (sn, sh, ss) of q, k, v and out in elements.
// stats: fp32 scratch of 2*batch*heads*S floats.
// Returns cudaGetLastError() after the launches (0 = success), or
// SDM_ERR_TOKENS, having launched nothing, when S is too long.
SDM_EXPORT int sdm_attention_forward(const void* q, const void* k,
                                     const void* v, void* o, float* stats,
                                     const long long* strides, int batch,
                                     int heads, int S, int D, float scale,
                                     int axis_q, int dt, void* stream_ptr) {
  View views[4];
  read_views(strides, views, 4);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bh = batch * heads;
  float* m = stats;
  float* l = stats + (long long)bh * S;
  const void* ptrs[4] = {q, k, v, o};
  if (mma_ok(dt, ptrs, views, S, D)) {
    if (S > WHOLE_S_MAX_MMA) return SDM_ERR_TOKENS;
    return launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(o), m, l,
                      views, bh, heads, S, D, scale, axis_q, stream);
  }
  if (apply_smem_bytes(S) > MAX_SMEM) return SDM_ERR_TOKENS;
  if (dt == SDM_F32)
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), m, l,
                  views, bh, heads, S, D, scale, axis_q, stream);
  return launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o), m, l, views,
                bh, heads, S, D, scale, axis_q, stream);
}

// Whether sdm_attention_forward takes S: on the tensor-core path
// (tensor_cores != 0) S <= WHOLE_S_MAX_MMA, on the CUDA-core path when the
// apply pass's 32 x S block fits in shared memory. kernels/attention.py
// mirrors this to choose between this kernel and the streaming one;
// chip_smoke.py holds the two against each other.
SDM_EXPORT int sdm_attention_fits(int S, int tensor_cores) {
  return tensor_cores ? S <= WHOLE_S_MAX_MMA : apply_smem_bytes(S) <= MAX_SMEM;
}

// The admission and the plan of the tensor-core path, for the Python
// mirrors in kernels/attention.py (checked against these on the card).
// ptrs: q, k, v, out; strides as sdm_attention_forward takes them.
SDM_EXPORT int sdm_attention_takes_mma(const void* const* ptrs,
                                       const long long* strides, int S, int D,
                                       int dt) {
  View views[4];
  read_views(strides, views, 4);
  return mma_ok(dt, ptrs, views, S, D);
}

// plan: three ints, (wide, split, d_per_block) of mma_plan.
SDM_EXPORT int sdm_attention_mma_plan(int bh, int S, int D, int* plan) {
  mma_plan(bh, S, D, plan, plan + 1, plan + 2);
  return 0;
}

SDM_EXPORT int sdm_attention_wide_smem_bytes(int D) {
  return (int)wide_smem_bytes(D);
}
