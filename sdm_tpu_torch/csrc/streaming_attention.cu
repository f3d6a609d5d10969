// Streaming (two-pass) self-attention forward, softmax over the query axis
// ("q", the reference's parity quirk) or the key axis ("k").
//
// Replaces the TPU kernels of sdm_tpu/kernels/streaming_attention.py::_forward:
// the stats pass (_stats_kernel, pallas_call at :223) and the apply pass
// (_apply_kernel, pallas_call at :234). Both stream (256, 256) tiles through
// VMEM so no S x S score block exists. On the H100 the whole-S kernel
// (attention.cu) keeps a 32 x S block of P in shared memory, which stops
// fitting past S = 3200 in bf16 and S = 1687 in fp32 (S = 4096 is the
// 256x256 SR model's layer-2 grid). This kernel never holds more than one
// score tile, and its shared memory does not depend on S:
//
//   1. stats, grid (S/64 kept rows, B): the shared kernels of
//      attention_tiles.cuh (column stats for "q", row stats for "k"), which
//      already loop over the reduced axis tile by tile.
//   2. apply, grid (S/32 query tiles, B, D/512 column splits): the block
//      walks all key tiles. For each it computes the 32 x 64 score tile with
//      the full-D contraction, turns it into P = exp(s - m) / l with the
//      final stats (no online rescaling: the stats pass is complete), rounds
//      P to v's dtype, and accumulates P V_j for its (up to) 512 output
//      columns in fp32 registers. One rounding to the input dtype at the end.
//
// bf16 at S % 64 == 0, D % 128 == 0 with 16-byte aligned rows (every U-Net
// shape) takes tensor-core kernels (WMMA 16x16x16, fp32 accumulation): the
// block's 32 x D query tile stays in shared memory for the whole key loop,
// and one shared buffer holds first the key tile (in 512-column chunks),
// then the value tile. fp32, and bf16 at other shapes, take CUDA-core
// kernels (fp32 FMA) that mask ragged tiles: keys past S give P = 0, and the
// stats count them as -inf. The kernel is bound by operations: 4*S*S*D per
// (batch, head) for the apply pass (scores and P V), 2*S*S*D for the stats.
// No pipelining (cp.async / TMA) and no wgmma yet: later work.
//
// q, k, v and out are (B, S, D) with arbitrary B and S strides and a unit D
// stride, so the attention block can pass views of its qkv buffer; m and l
// are (B, S) fp32.
#include "attention_tiles.cuh"

// Tensor-core apply.
#define SQ 32                 // queries per block
#define SK 64                 // keys per score tile
#define SDC 512               // output columns per block (4 warps x 128)
#define KCH 512               // D columns of one staged key chunk
#define KVLD (SDC + 8)        // bf16 pitch of the key/value buffer (KCH == SDC)
#define PLD (SK + 8)          // bf16 pitch of the P tile

// CUDA-core apply.
#define TQ 32                 // queries per block
#define TK 64                 // keys per score tile
#define TDC 512               // output columns per block
#define VK 16                 // value rows staged per step

static size_t stream_wmma_smem_bytes(int D) {
  return (size_t)SQ * (D + 8) * sizeof(bf16)     // Q tile
         + (size_t)SK * KVLD * sizeof(bf16)      // key chunk, then value tile
         + (size_t)SQ * PLD * sizeof(bf16)       // P tile
         + 8 * 256 * sizeof(float);              // per-warp fragment scratch
}

template <bool QAXIS>
__global__ void __launch_bounds__(256)
stream_apply_wmma(const bf16* __restrict__ q, View qv,
                  const bf16* __restrict__ k, View kv,
                  const bf16* __restrict__ v, View vv, bf16* __restrict__ o,
                  View ov, int S, int D, float scale,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using namespace nvcuda;
  const int qld = D + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);       // [SQ][D + 8]
  bf16* KV = Qs + SQ * qld;                           // [SK][KVLD]
  bf16* Ps = KV + SK * KVLD;                          // [SQ][PLD]
  float* W = reinterpret_cast<float*>(Ps + SQ * PLD);  // [8][256]

  const int b = blockIdx.y;
  const bf16* qp = slice_ptr(q, qv, 1, b);
  const bf16* kp = slice_ptr(k, kv, 1, b);
  const bf16* vp = slice_ptr(v, vv, 1, b);
  bf16* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const int i0 = blockIdx.x * SQ;
  const int dbeg = blockIdx.z * SDC;
  const int dcols = min(D - dbeg, SDC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  // Score tile: warp (wr, wc) owns rows wr*16.., keys wc*16..; P V: rows
  // wr*16.., output columns dbeg + wc*128 .. +128 (D % 128 == 0, so a warp's
  // columns are all in range or all out).
  const bool has_cols = wc * 128 < dcols;
  float* w = W + warp * 256;

  for (int c = threadIdx.x; c < SQ * (D / 8); c += blockDim.x) {
    const int r = c / (D / 8), kc = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * qld + kc) =
        *reinterpret_cast<const uint4*>(qp + (long long)(i0 + r) * qv.ss + kc);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int j0 = 0; j0 < S; j0 += SK) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
    wmma::fill_fragment(sacc, 0.f);
    for (int d0 = 0; d0 < D; d0 += KCH) {
      const int dn = min(KCH, D - d0);
      __syncthreads();   // the buffer's previous contents are consumed
      for (int c = threadIdx.x; c < SK * (dn / 8); c += blockDim.x) {
        const int r = c / (dn / 8), kc = (c % (dn / 8)) * 8;
        *reinterpret_cast<uint4*>(KV + r * KVLD + kc) =
            *reinterpret_cast<const uint4*>(kp + (long long)(j0 + r) * kv.ss +
                                            d0 + kc);
      }
      __syncthreads();
      for (int kk = 0; kk < dn; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + wr * 16 * qld + d0 + kk, qld);
        wmma::load_matrix_sync(fb, KV + wc * 16 * KVLD + kk, KVLD);
        wmma::mma_sync(sacc, fa, fb, sacc);
      }
    }
    wmma::store_matrix_sync(w, sacc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = wr * 16 + (e >> 4), c = wc * 16 + (e & 15);
      const int si = QAXIS ? j0 + c : i0 + r;
      Ps[r * PLD + c] =
          __float2bfloat16_rn(expf(w[e] * scale - mb[si]) / lb[si]);
    }
    __syncthreads();   // P complete; every warp is done with the key chunk
    for (int c = threadIdx.x; c < SK * (dcols / 8); c += blockDim.x) {
      const int r = c / (dcols / 8), cc = (c % (dcols / 8)) * 8;
      *reinterpret_cast<uint4*>(KV + r * KVLD + cc) =
          *reinterpret_cast<const uint4*>(vp + (long long)(j0 + r) * vv.ss +
                                          dbeg + cc);
    }
    __syncthreads();
    if (has_cols) {
#pragma unroll
      for (int kk = 0; kk < SK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + wr * 16 * PLD + kk, PLD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, KV + kk * KVLD + wc * 128 + j * 16, KVLD);
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
      const int col = dbeg + wc * 128 + j * 16 + (e & 15);
      op[(long long)row * ov.ss + col] = __float2bfloat16_rn(w[e]);
    }
    __syncwarp();
  }
}

template <typename T, bool QAXIS>
__global__ void __launch_bounds__(256)
stream_apply(const T* __restrict__ q, View qv, const T* __restrict__ k,
             View kv, const T* __restrict__ v, View vv, T* __restrict__ o,
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
  T* op = slice_ptr(o, ov, 1, b);
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
        op[(long long)row * ov.ss + col] = sdm_from_float<T>(acc[i][c]);
    }
  }
}

// The tensor-core kernels' admission: bf16, S % 64 == 0, D % 128 == 0,
// 16-byte aligned rows, and (apply only) the D-sized query tile fits.
static bool stream_wmma_ok(int dt, const void* const* ptrs, const View* views,
                           int n, int S, int D) {
  if (dt != SDM_BF16 || S % 64 != 0 || D % 128 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i]) || views[i].sn % 8 || views[i].ss % 8) return false;
  return stream_wmma_smem_bytes(D) <= MAX_SMEM;
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
  if (stream_wmma_ok(dt, ptrs, views, 2, S, D))
    return (int)launch_stats_wmma<streaming>(
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

template <typename T>
static int launch_apply(const T* q, const T* k, const T* v, T* o,
                        const View* views, int batch, int S, int D,
                        float scale, int axis_q, const float* m,
                        const float* l, cudaStream_t stream) {
  const dim3 grid((S + TQ - 1) / TQ, batch, (D + TDC - 1) / TDC);
  auto kernel = axis_q ? &stream_apply<T, true> : &stream_apply<T, false>;
  kernel<<<grid, 256, 0, stream>>>(q, views[0], k, views[1], v, views[2], o,
                                   views[3], S, D, scale, m, l);
  return (int)cudaGetLastError();
}

// strides: (sb, ss) of q, k, v and out in elements. m, l: the stats pass's
// (B, S) fp32 outputs for the same axis. out is written in the input dtype.
SDM_EXPORT int sdm_streaming_apply(const void* q, const void* k, const void* v,
                                   void* o, const float* m, const float* l,
                                   const long long* strides, int batch, int S,
                                   int D, float scale, int axis_q, int dt,
                                   void* stream_ptr) {
  View views[4];
  read_views(strides, views, 4);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* ptrs[4] = {q, k, v, o};
  if (stream_wmma_ok(dt, ptrs, views, 4, S, D)) {
    const size_t smem = stream_wmma_smem_bytes(D);
    const dim3 grid(S / SQ, batch, (D + SDC - 1) / SDC);
    auto kernel = axis_q ? &stream_apply_wmma<true> : &stream_apply_wmma<false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, 256, smem, stream>>>(
        static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
        views[1], static_cast<const bf16*>(v), views[2], static_cast<bf16*>(o),
        views[3], S, D, scale, m, l);
    return (int)cudaGetLastError();
  }
  if (dt == SDM_F32)
    return launch_apply(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o),
                        views, batch, S, D, scale, axis_q, m, l, stream);
  return launch_apply(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(o), views,
                      batch, S, D, scale, axis_q, m, l, stream);
}
