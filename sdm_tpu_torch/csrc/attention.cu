// Self-attention forward with the softmax over the query axis ("q", the
// reference's parity quirk) or the key axis ("k", standard attention).
//
// Replaces the TPU kernel sdm_tpu/kernels/attention.py::fused_attention
// (_attn_kernel: one whole S x S score tile per (batch*head) in VMEM). On the
// H100 a block has at most 227 KB of shared memory and blocks run in no
// order, and the head dimension here is the channel width (D = 512 or 1024),
// so both axes run two passes:
//
//   1. stats, grid (S/64 kept rows, B*H): per kept row the max m and the sum
//      l = sum exp(s - m) over ALL reduced rows, merged online tile by tile
//      (a block loops over the reduced tiles), to an fp32 scratch. On the q
//      axis the kept rows are the keys (column stats) and no output row can
//      be written before these exist; on the k axis they are the queries.
//   2. apply, grid (S/32 query tiles, B*H, D splits): the block computes its
//      32 x S score rows (D-chunked Q and K tiles), turns them into
//      P = exp(s - m) / l with the stats of the column (q) or the row (k),
//      rounds P to the value type (the reference's P.astype(v.dtype)), then
//      accumulates P V in fp32, 128 output columns at a time.
//
// bf16 inputs at S % 64 == 0, D % 128 == 0 with 16-byte aligned rows (every
// U-Net shape) take the tensor-core kernels further down (WMMA, fp32
// accumulation; P kept in shared memory in bf16). fp32 inputs, and bf16 at
// other shapes, take the SIMT kernels below (fp32 FMA on the CUDA cores;
// the 32 x S block kept in fp32). The score and P V products bound the
// kernel (4*S*S*D operations per head, plus the stats pass's 2*S*S*D).
// Shared memory bounds S: the entry point returns SDM_ERR_TOKENS, launching
// nothing, when the apply pass's 32 x S block does not fit
// (sdm_attention_fits says beforehand; longer grids take the streaming
// kernel, streaming_attention.cu).
//
// q, k, v and out are (N, S, H, D) with arbitrary N/S/H strides and a unit
// D stride, so the attention block can pass q/k/v as views of its qkv buffer.
// The stats kernels live in attention_tiles.cuh, shared with the streaming
// kernel.
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
// Tensor-core path for bf16 (WMMA 16x16x16, bf16 products, fp32
// accumulation), taken when S % 64 == 0, D % 128 == 0 and every row is
// 16-byte aligned, as at all the U-Net's shapes. The same two passes; the
// apply pass turns each 16 x 16 score fragment straight into bf16
// P = exp(s - m) / l in shared memory, so no fp32 score block is kept.
// ---------------------------------------------------------------------------

#define VCOLS 128       // output columns per P V pass
#define VLD (VCOLS + 8)

static size_t wmma_apply_smem_bytes(int S) {
  // bf16 P [32][S+8] + 8 per-warp 16x16 fp32 tiles + the staging area.
  const size_t staging = 64 * VLD * sizeof(bf16);   // >= (32+64)*WLD*2
  return (size_t)32 * (S + 8) * sizeof(bf16) + 8 * 256 * sizeof(float) +
         staging;
}

template <bool QAXIS>
__global__ void __launch_bounds__(256)
attn_apply_wmma(const bf16* __restrict__ q, View qv, const bf16* __restrict__ k,
                View kv, const bf16* __restrict__ v, View vv,
                bf16* __restrict__ o, View ov, int heads, int S, int D,
                int d_per_block, float scale, const float* __restrict__ m_in,
                const float* __restrict__ l_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using namespace nvcuda;
  const int ldp = S + 8;
  bf16* P = reinterpret_cast<bf16*>(smem_raw);                   // [32][S+8]
  float* W = reinterpret_cast<float*>(smem_raw + 64 * ldp);      // [8][256]
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + 64 * ldp + 8192);
  bf16* Ks = Qs + 32 * WLD;
  bf16* Vs = Qs;                                                 // [64][VLD]

  const int b = blockIdx.y;
  const bf16* qp = slice_ptr(q, qv, heads, b);
  const bf16* kp = slice_ptr(k, kv, heads, b);
  const bf16* vp = slice_ptr(v, vv, heads, b);
  bf16* op = o + (long long)(b / heads) * ov.sn + (long long)(b % heads) * ov.sh;
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const int i0 = blockIdx.x * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  float* w = W + warp * 256;

  // Phase 1: P[32][S], one 16x16 fragment per warp per 64-key tile.
  for (int j0 = 0; j0 < S; j0 += 64) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int d0 = 0; d0 < D; d0 += WBK) {
      stage_rows<32>(Qs, qp, qv.ss, i0, d0);
      stage_rows<64>(Ks, kp, kv.ss, j0, d0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + wr * 16 * WLD + kk, WLD);
        wmma::load_matrix_sync(fb, Ks + wc * 16 * WLD + kk, WLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(w, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = wr * 16 + (e >> 4), col = j0 + wc * 16 + (e & 15);
      const float s = w[e] * scale;
      const int si = QAXIS ? col : i0 + r;
      P[r * ldp + col] = __float2bfloat16_rn(expf(s - mb[si]) / lb[si]);
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase 2: out[i0:i0+32, cols] = P V; each warp 16 rows x 32 columns.
  const int dbeg = blockIdx.z * d_per_block;
  const int dend = min(D, dbeg + d_per_block);
  for (int c0 = dbeg; c0 < dend; c0 += VCOLS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int j0 = 0; j0 < S; j0 += 64) {
      for (int c = threadIdx.x; c < 64 * (VCOLS / 8); c += blockDim.x) {
        const int r = c / (VCOLS / 8), cc = (c % (VCOLS / 8)) * 8;
        *reinterpret_cast<uint4*>(Vs + r * VLD + cc) =
            *reinterpret_cast<const uint4*>(vp + (long long)(j0 + r) * vv.ss +
                                            c0 + cc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, P + wr * 16 * ldp + j0 + kk, ldp);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * VLD + wc * 32 + j * 16, VLD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(w, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i0 + wr * 16 + (e >> 4);
        const int col = c0 + wc * 32 + j * 16 + (e & 15);
        op[(long long)row * ov.ss + col] = __float2bfloat16_rn(w[e]);
      }
      __syncwarp();
    }
  }
}

static bool wmma_ok(const void* q, const void* k, const void* v,
                    const void* o, const View* views, int S, int D) {
  if (S % 64 != 0 || D % VCOLS != 0) return false;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return false;
  for (int i = 0; i < 4; ++i)
    if (views[i].sn % 8 || views[i].sh % 8 || views[i].ss % 8) return false;
  return true;
}

// Output-column split so a small grid still fills the card (each split
// recomputes the scores); d_per_block is a multiple of `cols`.
static void split_columns(int blocks, int D, int cols, int* split,
                          int* d_per_block) {
  const int chunks = (D + cols - 1) / cols;
  int s = (2 * 132 + blocks - 1) / blocks;
  s = s < 1 ? 1 : (s > chunks ? chunks : s);
  *d_per_block = ((chunks + s - 1) / s) * cols;
  *split = (D + *d_per_block - 1) / *d_per_block;
}

static int launch_wmma(const bf16* qp, const bf16* kp, const bf16* vp,
                       bf16* out, float* m, float* l, const View* views,
                       int bh, int heads, int S, int D, float scale,
                       int axis_q, cudaStream_t stream) {
  cudaError_t err = launch_stats_wmma<whole_s>(
      qp, views[0], kp, views[1], bh, heads, S, D, scale, axis_q, m, l, stream);
  if (err != cudaSuccess) return (int)err;
  int split, d_per_block;
  split_columns(bh * (S / 32), D, VCOLS, &split, &d_per_block);
  const size_t smem = wmma_apply_smem_bytes(S);
  const dim3 grid(S / 32, bh, split);
  auto kernel = axis_q ? &attn_apply_wmma<true> : &attn_apply_wmma<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<grid, 256, smem, stream>>>(qp, views[0], kp, views[1], vp,
                                      views[2], out, views[3], heads, S, D,
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
  split_columns(bh * ((S + ABM - 1) / ABM), D, ADT, &split, &d_per_block);
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
  for (int i = 0; i < 4; ++i)
    views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bh = batch * heads;
  float* m = stats;
  float* l = stats + (long long)bh * S;
  if (dt == SDM_BF16 && wmma_ok(q, k, v, o, views, S, D)) {
    if (wmma_apply_smem_bytes(S) > MAX_SMEM) return SDM_ERR_TOKENS;
    return launch_wmma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(o), m,
                       l, views, bh, heads, S, D, scale, axis_q, stream);
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

// Whether sdm_attention_forward takes S: 1 when the apply pass's block fits
// in shared memory on the tensor-core path (wmma != 0) or the CUDA-core path.
// kernels/attention.py mirrors this formula to choose between this kernel and
// the streaming one; chip_smoke.py holds the two against each other.
SDM_EXPORT int sdm_attention_fits(int S, int wmma) {
  return (wmma ? wmma_apply_smem_bytes(S) : apply_smem_bytes(S)) <= MAX_SMEM;
}
