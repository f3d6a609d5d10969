// Tile helpers and the kernels of the streaming attention
// (streaming_attention.cu), some shared with the whole-S attention
// (attention.cu): the softmax statistics (attn_stats, the CUDA-core kernel
// of both; attn_stats_mma) and the tensor-core apply pass
// (stream_apply_mma). The whole-S attention's tensor-core kernels are its
// own (attention.cu, on wgmma_tiles.cuh).
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
// pass, attn_stats_mma<streaming> the streaming kernel's.
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
// Tensor-core stats: attn_stats_mma<Caller>, bf16 in, fp32 (m, l) out.
//
// Replaces the TPU's stats pass of the streaming kernel
// (sdm_tpu/kernels/streaming_attention.py:97 _stats_kernel, pallas_call at
// :223). Bound: operations, 2*S*S*D per
// batch*head (the scores), against 2*S*D*2 bytes in and 8*S out: at S =
// 4096, D = 512 about 2,000 operations per byte, far above the H100's ~295.
//
// Block: 64 kept rows, 512 threads (16 warps), one block per SM, grid
// (S/64, B*H). Shared memory: the kept tile [64][D+8] bf16, loaded once by
// cp.async and resident; a ring of SSTAGES = 2 (reduced tile, D chunk)
// stages [256][CHUNK+8] bf16, 256 reduced rows x CHUNK columns each, the
// next one in flight (cp.async.cg, 16 bytes a copy) while the tensor cores
// work on this one. CHUNK is 128 where the kept tile leaves room (D <= 640)
// and 64 past it, so the ring's bytes do not grow with D: 205,824 bytes at
// D = 512 and at D = 1024, and D <= 1152 fits. The kernel needs none of the
// apply's V or P. Warps per SM set its pace more than bytes in flight: on an
// H100 SXM (700 W, chip_smoke.py) 8 warps with a 4-stage ring of 128 x 64
// stages took 2.05 ms at 16 x 4096 x 512, 16 warps with 2 stages of
// 256 x 64 took 1.74; the wider chunk halves the barriers per tile.
//
// Warp w owns kept rows 32 (w / 8) .. +32 and reduced columns 32 (w % 8) ..
// +32 of each 256-row tile: per 16-deep step two ldmatrix.x4 of kept rows
// (A) and two of reduced rows (B, stored [row][d], B's column-major layout:
// plain ldmatrix) feed eight m16n8k16 mma.sync, two mma per ldmatrix.x4. The
// 32 x 32 fp32 scores stay in registers across the D chunks of a tile.
//
// (m, l) stay in registers on the accumulator fragments: lane L holds rows
// L/4 and L/4 + 8 of each 16-row fragment, so four kept rows, each with 8 of
// the tile's scores. At the tile's last chunk: scale, the lane's maximum,
// __shfl_xor_sync over 1 and 2 within the quad (the row's 32 columns), then
// the online merge l <- l exp(m - m') + sum exp(s - m'). The eight warps
// that share kept rows merge once at the end through 4 KB of shared memory
// (m = max m_w, l = sum l_w exp(m_w - m)). Where S % 256 != 0 the last tile
// is short, and the warps whose columns lie past S skip it.
//
// What this design does about the WMMA kernel it replaced: that kernel
// staged both the kept and the reduced tile with synchronous copies between
// two barriers for every 64-deep chunk of every reduced tile (the kept rows
// read from L2 again S/64 times, nothing in flight during the products);
// here the kept rows load once and the reduced rows stream through the ring.
// It stored every 64 x 64 score tile to an fp32 shared tile, then 64 of 256
// threads walked 64 fmaxf and 64 expf each in series while six warps waited;
// here every lane does its 8 exponentials per row on the fragments and no
// score touches shared memory. Its warp tile was 16 x 32 (one WMMA A load
// per two products); here 32 x 32, with twice the warps per SM.
// ---------------------------------------------------------------------------

#define SKEPT 64            // kept rows per block (resident)
#define SCW 8               // warps across the reduced tile (32 rows each)
#define SRED 256            // reduced rows per streamed tile (32 * SCW)
#define SCHUNK 128          // D columns per ring stage (half past D = 640)
#define SSTAGES 2           // ring depth
#define STHREADS 512        // 2 x SCW warps

static size_t stats_ring_bytes(int chunk) {
  return (size_t)SSTAGES * SRED * (chunk + 8) * sizeof(bf16);
}

// The ring's chunk width at D: SCHUNK where the kept tile leaves room for
// it, else SCHUNK / 2.
static int stats_mma_chunk(int D) {
  const size_t kept = (size_t)SKEPT * (D + 8) * sizeof(bf16);
  return kept + stats_ring_bytes(SCHUNK) <= MAX_SMEM ? SCHUNK : SCHUNK / 2;
}

static size_t stats_mma_smem_bytes(int D) {
  return (size_t)SKEPT * (D + 8) * sizeof(bf16)             // kept tile
         + stats_ring_bytes(stats_mma_chunk(D));            // ring
}

// attn_stats_mma's admission: bf16, S % 64 == 0, D % 128 == 0, the shared
// memory within MAX_SMEM (D <= 1152) and 16-byte aligned rows of q and k.
static bool stats_mma_ok(int dt, const void* const* ptrs, const View* views,
                         int S, int D) {
  return dt == SDM_BF16 && S % SKEPT == 0 && D % 128 == 0 &&
         stats_mma_smem_bytes(D) <= MAX_SMEM && rows_aligned16(ptrs, views, 2);
}

template <typename Caller, int CHUNK>
__global__ void __launch_bounds__(STHREADS, 1)
attn_stats_mma(const bf16* __restrict__ kept, View kv,
               const bf16* __restrict__ red, View rv, int heads, int S, int D,
               float scale, float* __restrict__ m_out,
               float* __restrict__ l_out) {
  constexpr int LDR = CHUNK + 8;   // bf16 pitch of a ring stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [SKEPT][ld]
  bf16* Ring = Ks + SKEPT * ld;                  // [SSTAGES][SRED][LDR]

  const int b = blockIdx.y;
  const bf16* kp = slice_ptr(kept, kv, heads, b);
  const bf16* rp = slice_ptr(red, rv, heads, b);
  const int a0 = blockIdx.x * SKEPT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp / SCW, wc = warp % SCW;
  const int g = lane >> 2, tg = lane & 3;
  const int nchunks = D / CHUNK;
  const int nsteps = ((S + SRED - 1) / SRED) * nchunks;

  // The kept tile joins the first cp.async group, with ring step 0.
  cp_async_rows(Ks, ld, kp + (long long)a0 * kv.ss, kv.ss, SKEPT, D / 8, tid,
                STHREADS);
  // Ring step i: reduced tile i / nchunks, D chunk i % nchunks.
  auto load_step = [&](int i) {
    const int t = i / nchunks, c = i - t * nchunks;
    const int r0 = t * SRED;
    cp_async_rows(Ring + (i % SSTAGES) * SRED * LDR, LDR,
                  rp + (long long)r0 * rv.ss + c * CHUNK, rv.ss,
                  min(SRED, S - r0), CHUNK / 8, tid, STHREADS);
  };
#pragma unroll
  for (int i = 0; i < SSTAGES - 1; ++i) {
    if (i < nsteps) load_step(i);
    cp_async_commit();
  }

  // ldmatrix lane addresses. A (kept rows): lanes 0-15 rows 0-15 at column
  // 0, lanes 16-31 rows 0-15 at column 8. B (reduced rows): lanes 0-7 rows
  // 0-7 / d 0, 8-15 rows 0-7 / d 8, 16-23 rows 8-15 / d 0, 24-31 rows 8-15 /
  // d 8, so registers 0-1 are row block 0's fragment and 2-3 row block 1's.
  const unsigned ka = smem_u32(Ks + (wr * 32 + (lane & 15)) * ld +
                               (lane >> 4) * 8);
  const int rb_off = (wc * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDR +
                     ((lane >> 3) & 1) * 8;

  // Rows wr*32 + 16 mi + g + 8 hh at index 2 mi + hh.
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float acc[2][4][4];

  for (int i = 0; i < nsteps; ++i) {
    const int t = i / nchunks, c = i - t * nchunks;
    cp_async_wait<SSTAGES - 2>();
    // Step i (and the kept tile) visible to every warp; every warp is done
    // with step i - 1, so its stage may be overwritten.
    __syncthreads();
    if (i + SSTAGES - 1 < nsteps) load_step(i + SSTAGES - 1);
    cp_async_commit();

    if (c == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
    }
    if (t * SRED + wc * 32 >= S) continue;   // columns past S (warp-uniform)

    const unsigned rb = smem_u32(Ring + (i % SSTAGES) * SRED * LDR + rb_off);
    const unsigned kc = ka + c * CHUNK * 2;
#pragma unroll
    for (int kk = 0; kk < CHUNK; kk += 16) {
      unsigned a[2][4], br[2][4];
      ldsm_x4(a[0], kc + kk * 2);
      ldsm_x4(a[1], kc + (16 * ld + kk) * 2);
      ldsm_x4(br[0], rb + kk * 2);
      ldsm_x4(br[1], rb + (16 * LDR + kk) * 2);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16(acc[mi][2 * nj], a[mi], br[nj][0], br[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], br[nj][2], br[nj][3]);
        }
    }

    if (c == nchunks - 1) {   // the tile's scores are complete
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float tmax = -INFINITY;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[mi][n][2 * hh + e] *= scale;
              tmax = fmaxf(tmax, acc[mi][n][2 * hh + e]);
            }
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const int r = 2 * mi + hh;
          const float mn = fmaxf(m[r], tmax);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) sum += expf(acc[mi][n][2 * hh + e] - mn);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[r] = l[r] * expf(m[r] - mn) + sum;
          m[r] = mn;
        }
    }
  }

  // Merge the column warps of each kept row through shared memory (the
  // ring is free once every warp has passed this barrier).
  cp_async_wait<0>();
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(Ring);   // [SCW column warps][SKEPT]
  float* Lw = Mw + SCW * SKEPT;
  if (tg == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wr * 32 + 16 * (r >> 1) + g + 8 * (r & 1);
      Mw[wc * SKEPT + row] = m[r];
      Lw[wc * SKEPT + row] = l[r];
    }
  }
  __syncthreads();
  if (tid < SKEPT) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < SCW; ++w) mm = fmaxf(mm, Mw[w * SKEPT + tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < SCW; ++w)
      ll += Lw[w * SKEPT + tid] * expf(Mw[w * SKEPT + tid] - mm);
    m_out[(long long)b * S + a0 + tid] = mm;
    l_out[(long long)b * S + a0 + tid] = ll;
  }
}

template <typename Caller>
static cudaError_t launch_stats_mma(const bf16* qp, View qv, const bf16* kp,
                                    View kv, int bh, int heads, int S, int D,
                                    float scale, int axis_q, float* m,
                                    float* l, cudaStream_t stream) {
  const size_t smem = stats_mma_smem_bytes(D);
  auto kernel = stats_mma_chunk(D) == SCHUNK
                    ? &attn_stats_mma<Caller, SCHUNK>
                    : &attn_stats_mma<Caller, SCHUNK / 2>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(S / SKEPT, bh);
  if (axis_q)
    kernel<<<grid, STHREADS, smem, stream>>>(kp, kv, qp, qv, heads, S, D,
                                             scale, m, l);
  else
    kernel<<<grid, STHREADS, smem, stream>>>(qp, qv, kp, kv, heads, S, D,
                                             scale, m, l);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core apply: stream_apply_mma<OutT, QAXIS, Pass>, out[i] = sum_j
// round_bf16(exp(s_ij - m) / l) v_j with the final stats of the pass above.
//
// Replaces the TPU's _apply_kernel (sdm_tpu/kernels/streaming_attention.py
// :120, pallas_call at :234) and, launched with the roles swapped, its
// _dv_kernel (:133, pallas_call at :298). Bound: operations,
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
