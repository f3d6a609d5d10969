// Streaming (two-pass) self-attention, forward and backward, softmax over the
// query axis ("q", the reference's parity quirk) or the key axis ("k").
//
// Replaces the TPU kernels of sdm_tpu/kernels/streaming_attention.py: the
// forward's stats pass (_stats_kernel, pallas_call at :223) and apply pass
// (_apply_kernel, pallas_call at :234), and the backward's dV pass
// (_dv_kernel, pallas_call at :298), dK pass (_dk_kernel, :260) and dQ pass
// (_dq_kernel, :271); the backward is described further down. Both stream (256, 256) tiles through
// VMEM so no S x S score block exists. On the H100 the whole-S kernel
// (attention.cu) keeps a 32 x S block of P in shared memory, which stops
// fitting past S = 3200 in bf16 and S = 1687 in fp32 (S = 4096 is the
// 256x256 SR model's layer-2 grid). This kernel never holds more than one
// score tile, and its shared memory does not depend on S:
//
//   1. stats, grid (S/64 kept rows, B): the shared kernels of
//      attention_tiles.cuh (column stats for "q", row stats for "k"), which
//      already loop over the reduced axis tile by tile.
//   2. apply: each block owns a tile of queries and walks all key tiles.
//      For each it computes the score tile with the full-D contraction,
//      turns it into P = exp(s - m) / l with the final stats (no online
//      rescaling: the stats pass is complete), rounds P to v's dtype, and
//      accumulates P V_j for its output columns in fp32 registers. One
//      rounding to the output type at the end.
//
// The stats pass takes WMMA tensor-core tiles for bf16 at S % 64 == 0,
// D % 128 == 0 with 16-byte aligned rows. The apply pass (and the dV pass,
// which is the apply pass with the roles swapped) takes stream_apply_mma
// for bf16 at those shapes with D <= 512 (every U-Net shape that streams):
// mma.sync with ldmatrix fragments and a cp.async ring, described at the
// kernel. fp32, and bf16 at other shapes, take CUDA-core kernels (fp32 FMA)
// that mask ragged tiles: keys past S give P = 0, and the stats count them
// as -inf. The apply pass is bound by operations: 4*S*S*D per (batch, head)
// (scores and P V), 2*S*S*D for the stats.
//
// q, k, v and out are (B, S, D) with arbitrary B and S strides and a unit D
// stride, so the attention block can pass views of its qkv buffer; m and l
// are (B, S) fp32. The apply pass writes out in the input dtype, or in fp32
// (the key-axis backward keeps the fp32 output as a residual).
#include "attention_tiles.cuh"

// Pass tags, so a profiler trace names the apply kernel's two callers apart
// (stream_apply_mma<float, false, dv_pass> is the dV pass) and dK from dQ.
struct apply_pass {};
struct dv_pass {};
struct dk_pass {};
struct dq_pass {};

// ---------------------------------------------------------------------------
// Tensor-core apply: stream_apply_mma<OutT, QAXIS, Pass>.
//
// Replaces the TPU's _apply_kernel (sdm_tpu/kernels/streaming_attention.py
// :120, pallas_call at :234) and, launched with the roles swapped, its
// _dv_kernel (:133, pallas_call at :298). Bound: operations, 4*S*S*D per
// batch row (the score tile's q k^T and P V, each 2*S*S*D), against bytes of
// 4*S*D*2 + 8*S: at S = 4096, D = 512 about 1000 operations per byte, far
// above the H100's ~295 for bf16.
//
// Block: 64 own queries, 256 threads (8 warps), one block per SM, grid
// (S/64, B). Shared memory at D = 512 (205,312 bytes):
//   Q tile   [64][D+8] bf16, loaded once by cp.async, resident;
//   ring     2 stages x (K, V) [32][D+8] bf16: 32-key tiles, tile j+1 in
//            flight (cp.async.cg, 16 bytes a copy) while tile j is computed;
//            on the query axis each stage also carries its 32 keys' m and l;
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
//   P V      warp (r, h) owns rows 16r.. and D/2 output columns: A (P) by
//            ldmatrix.x4, B (V, stored [key][d]) by ldmatrix.x4.trans, a
//            16 x 256 fp32 accumulator per warp (128 registers a thread).
// The epilogue rounds once to OutT and stores straight from the fragments
// (bf16 or fp32 pairs).
//
// What this design does about the WMMA kernel it replaced: that kernel owned
// 32 queries per block (K and V read from L2 S/32 times per batch row; here
// S/64); its loads were synchronous 16-byte copies between barriers (four
// per 64-key tile, nothing in flight during the products; here one tile is
// always in flight and there are two barriers per tile); and its scores went
// through a per-warp fp32 scratch with m and l read from global memory per
// element (here P is formed in registers, the stats staged with the tile),
// and WMMA's opaque fragments forced reloading V per 16-column slice (here
// each V fragment is loaded once per warp and used by two products).
// ---------------------------------------------------------------------------

#define MQ 64                 // own queries per block
#define MK 32                 // keys per streamed tile
#define MMAXD 512             // widest D of the tensor-core apply
#define MPLD (MK + 8)         // bf16 pitch of its P tile
#define MTHREADS 256

// CUDA-core apply.
#define TQ 32                 // queries per block
#define TK 64                 // keys per score tile
#define TDC 512               // output columns per block
#define VK 16                 // value rows staged per step

static size_t stream_mma_smem_bytes(int D) {
  return (size_t)MQ * (D + 8) * sizeof(bf16)            // Q tile
         + 2 * 2 * (size_t)MK * (D + 8) * sizeof(bf16)  // ring: K and V
         + (size_t)MQ * MPLD * sizeof(bf16)             // P tile
         + 2 * 2 * MK * sizeof(float);                  // ring: m and l
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: a the 4-register bf16 A fragment, (b0, b1)
// the B fragment, c the fp32 accumulator fragment.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename OutT, bool QAXIS, typename Pass>
__global__ void __launch_bounds__(MTHREADS, 1)
stream_apply_mma(const bf16* __restrict__ q, View qv,
                 const bf16* __restrict__ k, View kv,
                 const bf16* __restrict__ v, View vv, OutT* __restrict__ o,
                 View ov, int S, int D, float scale,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);           // [MQ][ld]
  bf16* Ring = Qs + MQ * ld;                              // [2][K, V][MK][ld]
  bf16* Ps = Ring + 4 * MK * ld;                          // [MQ][MPLD]
  float* St = reinterpret_cast<float*>(Ps + MQ * MPLD);   // [2][m, l][MK]

  const int b = blockIdx.y;
  const bf16* qp = slice_ptr(q, qv, 1, b);
  const bf16* kp = slice_ptr(k, kv, 1, b);
  const bf16* vp = slice_ptr(v, vv, 1, b);
  OutT* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const int i0 = blockIdx.x * MQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wh = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  const int cpr = D / 8;              // 16-byte chunks per row
  const int wcols = D / 2;            // P V output columns per warp
  const int cbase = wh * wcols;

  // The Q tile joins the first cp.async group, with key tile 0.
  for (int c = tid; c < MQ * cpr; c += MTHREADS) {
    const int r = c / cpr, cc = (c - r * cpr) * 8;
    cp_async16(smem_u32(Qs + r * ld + cc),
               qp + (long long)(i0 + r) * qv.ss + cc);
  }
  // Key tile at j0 into ring stage `st`: this thread's chunks are c = tid +
  // 256 i of the row-major (MK, cpr) chunk grid, walked incrementally.
  const int step_r = MTHREADS / cpr, step_c = MTHREADS - step_r * cpr;
  auto load_tile = [&](int j0, int st) {
    bf16* Ks = Ring + st * 2 * MK * ld;
    bf16* Vs = Ks + MK * ld;
    int r = tid / cpr, cc = tid - r * cpr;
    while (r < MK) {
      cp_async16(smem_u32(Ks + r * ld + cc * 8),
                 kp + (long long)(j0 + r) * kv.ss + cc * 8);
      cp_async16(smem_u32(Vs + r * ld + cc * 8),
                 vp + (long long)(j0 + r) * vv.ss + cc * 8);
      r += step_r;
      cc += step_c;
      if (cc >= cpr) {
        cc -= cpr;
        ++r;
      }
    }
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
    cp_async_wait_all();
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

#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = wh * 16 + n * 8 + 2 * tg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[0][n][2 * hh + e] + s[1][n][2 * hh + e];
          const float mm = QAXIS ? St[st * 2 * MK + col + e] : mrow[hh];
          const float ll = QAXIS ? St[st * 2 * MK + MK + col + e] : lrow[hh];
          pr[e] = expf(sv * scale - mm) / ll;
        }
        store_pair(Ps + (wr * 16 + g + 8 * hh) * MPLD + col, pr[0], pr[1]);
      }
    }
    __syncthreads();   // the P tile is complete

#pragma unroll
    for (int kk = 0; kk < MK; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, pa + kk * 2);
#pragma unroll
      for (int np = 0; np < 16; ++np) {
        if (np * 16 < wcols) {
          unsigned bv[4];
          ldsm_x4_trans(bv, vb + (kk * ld + np * 16) * 2);
          mma_bf16(acc[2 * np], a, bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 32; ++n) {
    if (n * 8 < wcols) {
      const int col = cbase + n * 8 + 2 * tg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = i0 + wr * 16 + g + 8 * hh;
        store_pair(op + (long long)row * ov.ss + col, acc[n][2 * hh],
                   acc[n][2 * hh + 1]);
      }
    }
  }
}

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

static bool rows_aligned16(const void* const* ptrs, const View* views,
                           int n) {
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i]) || views[i].sn % 8 || views[i].ss % 8)
      return false;
  return true;
}

// The WMMA stats kernel's admission: bf16, S % 64 == 0, D % 128 == 0,
// 16-byte aligned rows, D <= 2304. The kernel stages 64-column chunks and
// has no limit on D itself; 2304 is the widest D this path has admitted
// (the bound came from the shared memory of an earlier apply kernel), kept
// so that no shape changes kernel.
static bool stream_stats_wmma_ok(int dt, const void* const* ptrs,
                                 const View* views, int S, int D) {
  return dt == SDM_BF16 && S % 64 == 0 && D % 128 == 0 && D <= 2304 &&
         rows_aligned16(ptrs, views, 2);
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
  if (stream_stats_wmma_ok(dt, ptrs, views, S, D))
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

// The apply kernel for out[i] = sum_j round_v(P_ij) v_j with P from (q, k,
// m, l) on `axis_q`, the output in OutT. The dV pass calls it with the roles
// swapped (see sdm_streaming_dv).
template <typename Pass, typename OutT>
static int launch_apply(const void* q, const void* k, const void* v, OutT* o,
                        const View* views, int batch, int S, int D,
                        float scale, int axis_q, const float* m,
                        const float* l, int dt, cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, o};
  if (stream_mma_ok(dt, ptrs, views, S, D)) {
    const size_t smem = stream_mma_smem_bytes(D);
    auto kernel = axis_q ? &stream_apply_mma<OutT, true, Pass>
                         : &stream_apply_mma<OutT, false, Pass>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<dim3(S / MQ, batch), MTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
        views[1], static_cast<const bf16*>(v), views[2], o, views[3], S, D,
        scale, m, l);
    return (int)cudaGetLastError();
  }
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
// take them: q, k (stats) or q, k, v, out (apply). stream_mma_smem_bytes is
// the apply kernel's dynamic shared memory.
SDM_EXPORT int sdm_streaming_stats_takes_wmma(const void* const* ptrs,
                                              const long long* strides, int S,
                                              int D, int dt) {
  View views[2];
  read_views(strides, views, 2);
  return stream_stats_wmma_ok(dt, ptrs, views, S, D);
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
