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
// bf16 inputs at S % 64 == 0, D % 64 == 0, D <= 1024 with 16-byte aligned
// rows and strides (every U-Net shape) run on the tensor cores through TMA
// and wgmma: the stats on attn_stats_wgmma, the apply on
// attn_apply_wgmma (below), split over output columns where that costs
// least (wgmma_plan). fp32 inputs, and bf16 at other shapes, take the SIMT
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
//
// attention.cu exports these kernels alone (`fused_attention`); the
// attention block's one C call (attention_block.cu) launches them between
// its projections, and at D = 512 its apply carries the output projection
// (attn_apply_wgmma<QAXIS, 4, true>, below).
#pragma once

#include "attention_tiles.cuh"
#include "wgmma_tiles.cuh"

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
// The bf16 tensor-core path: attn_stats_wgmma, then attn_apply_wgmma<QAXIS,
// NB>, both on TMA + wgmma (wgmma_tiles.cuh).
//
// WHOLE_S_MAX_MMA: the longest S the tensor-core path takes whole (3200,
// the bound the shared memory of the former WMMA apply's 32 x S P block set,
// kept as a constant). Its kernels do not depend on S, but the route does:
// the whole-S path's backward is the plain recompute with an S x S softmax
// (sdm_tpu's VJP, attention.py:193), while past this S the streaming kernel
// runs its own backward kernels, so moving the limit would change the SR
// trainer's memory and kernels. kernels/attention.py mirrors it.
//
// Both kernels replace the TPU's _attn_kernel (sdm_tpu/kernels/attention.py
// :43, pallas_call at :86), which holds one whole S x S score tile per
// batch*head in VMEM. Both are bound by operations: the stats 2*S*S*D per
// batch*head, the apply 4*S*S*D (Q K^T and P V), against 4*S*D*2 bytes: at
// S = 1024, D = 512 about 1000 operations a byte, far above the H100's ~295
// for bf16. So the design feeds the tensor cores the way linear_wgmma does:
// no thread loads an operand. A block is two consumer warpgroups, one
// block an SM (the stats add a producer warp, 288 threads; the apply's
// warps refill the ring themselves, 256). TMA loads the block's resident
// 64-row tile first (Q, or the kept rows of the stats), then the streamed
// rows, each load WCHUNKS = 2 chunks of 64 columns of D (128B-swizzled
// tiles, one after the other), through a ring of stages, each with a
// "full" mbarrier (its TMA bytes). The consumers wait for a stage to be
// full, issue wgmma on it with both operands named by descriptors, and
// release it once the wgmma that read it have retired: lane 0 of each of
// the eight warps arrives on the stage's "empty" mbarrier, for which the
// stats' producer waits, or counts itself in the apply (after
// wgmma.wait_group). The maps are rank 5 over (64 columns, S, D/64
// chunks, H, N) (sdm_tma_map_chunks), so q, k and v may be strided views of
// the block's qkv buffer, a box never reads past its own batch row, and an
// odd last chunk is zero-filled past D (its products add zeros).
//
// Four things held the first version of these kernels (one 64-column box
// a load) to 1.5x the mma.sync kernels' time, all measured with
// tools/torch_attention_tiles.py on the H100: ptxas serialized every
// wgmma (a full wait after each) wherever a wgmma, fence or wait sat under
// a branch on the warpgroup or after a barrier wait's loop without a fence
// of its own, or wanted more registers than a block of nine warps leaves
// (168 a thread); the TMA unit delivered one load per ~0.33 us an SM
// whatever its size, so 8 KB boxes starved the products; exp with an IEEE
// division made P slow; and a producer thread that
// waited for releases stalled the warps around it. Here every wgmma runs
// in every warpgroup (a select or a repeated chunk where one has nothing
// to do), the apply has no producer warp (up to 255 registers), each load
// carries two chunks, P is exp2 of prescaled scores times a reciprocal,
// and the last warp to release a stage refills it.
//
// What the design does about the mma.sync kernels it replaced
// (attn_stats_mma and stream_apply_mma, tagged whole_s, and
// attn_apply_mma_wide, at 0.640 ms a flagship call, 12x their bound): those
// fed mma.sync m16n8k16 from ldmatrix fragments of padded shared tiles,
// every thread issued cp.async and met a __syncthreads() every 32-key step,
// P made a round trip through shared memory in every warp, and the column
// split of the apply recomputed the scores per split wherever the grid was
// small. Here the copies are TMA's, the waits are per stage, the products
// are 64-row wgmma, and the split is chosen by cost (wgmma_plan).
// ---------------------------------------------------------------------------

#define WHOLE_S_MAX_MMA 3200

#define WROWS 64          // kept rows (stats) and queries (apply) a block
#define WBOX 64           // columns of D a chunk: one 128-byte row
#define WCHUNKS 2         // chunks a TMA load
#define WMAX_D 1024       // widest D the path takes
#define WCOLS 512         // widest output-column slice of an apply block
#define WRED 128          // reduced rows a stats load: 64 a warpgroup
#define WSTATS_STAGES 8   // most stats ring stages (128 rows x 2 chunks)
#define WAPPLY_STAGES 16  // most apply ring stages (64 rows x 2 chunks)
#define WTHREADS 288      // stats: two consumer warpgroups, a producer warp
#define WAPPLY_THREADS 256  // apply: two warpgroups that refill their ring
#define WSMS 132          // SMs of the H100

static constexpr int kChunkBytes = WROWS * WBOX * 2;   // a 64 x 64 tile
static constexpr int kLoadBytes = WCHUNKS * kChunkBytes;
// Alignment slack (1024) and room for the barriers (512) of either kernel.
static constexpr int kFixedBytes = 1024 + 512;
static constexpr float kLog2e = 1.4426950408889634f;

// Chunks of D rounded up to whole loads: the resident tile's size.
__host__ __device__ static inline int wgmma_chunks(int D) {
  return (D / WBOX + WCHUNKS - 1) / WCHUNKS * WCHUNKS;
}

// Ring stages where the shared memory leaves room: the stats kernel keeps
// the 64 kept rows and the warpgroups' 64 (m, l) pairs beside its ring,
// the apply kernel Q and two P tiles.
static int wgmma_stats_stages(int D) {
  const long long room = MAX_SMEM - kFixedBytes - 2 * 2 * WROWS * 4 -
                         (long long)wgmma_chunks(D) * kChunkBytes;
  const long long n = room / (2 * kLoadBytes);
  return (int)(n < WSTATS_STAGES ? n : WSTATS_STAGES);
}

static int wgmma_apply_stages(int D) {
  const long long room =
      MAX_SMEM - kFixedBytes - (long long)(wgmma_chunks(D) + 2) * kChunkBytes;
  const long long n = room / kLoadBytes;
  return (int)(n < WAPPLY_STAGES ? n : WAPPLY_STAGES);
}

static size_t wgmma_stats_smem_bytes(int D) {
  return kFixedBytes + 2 * 2 * WROWS * 4 +
         (size_t)wgmma_chunks(D) * kChunkBytes +
         (size_t)wgmma_stats_stages(D) * 2 * kLoadBytes;
}

static size_t wgmma_apply_smem_bytes(int D) {
  return kFixedBytes + (size_t)(wgmma_chunks(D) + 2) * kChunkBytes +
         (size_t)wgmma_apply_stages(D) * kLoadBytes;
}

// The path's admission: bf16, S % 64 == 0, D % 64 == 0 with D <= 1024 and
// both kernels' shared memory within MAX_SMEM (at least the apply's four V
// loads of a 512-column slice in its ring), and what TMA needs of q, k and
// v and the epilogue's 16-byte stores of out: 16-byte aligned bases and N,
// H and S strides that are multiples of 8 elements.
static bool wgmma_ok(int dt, const void* const* ptrs, const View* views,
                     int S, int D) {
  return dt == SDM_BF16 && S > 0 && S % WROWS == 0 && D > 0 &&
         D % WBOX == 0 && D <= WMAX_D && wgmma_stats_stages(D) >= 2 &&
         wgmma_apply_stages(D) >= WCOLS / WBOX / WCHUNKS &&
         wgmma_stats_smem_bytes(D) <= MAX_SMEM &&
         wgmma_apply_smem_bytes(D) <= MAX_SMEM &&
         rows_aligned16(ptrs, views, 4);
}

// The apply's column split: `split` blocks per query tile, each `cols`
// output columns (whole chunks, at most WCOLS: two warpgroups of at most
// 192 fp32 columns). Each split recomputes Q K^T over all of D, so the cost
// of a block is D + cols; the plan takes the split of least cost over the
// waves of one block an SM (ties to the smaller split).
static void wgmma_plan(int bh, int S, int D, int* split, int* cols) {
  const int boxes = D / WBOX, blocks = bh * (S / WROWS);
  long long best = -1;
  for (int s = (D + WCOLS - 1) / WCOLS; s <= boxes; ++s) {
    const int per = (boxes + s - 1) / s;
    if ((boxes + per - 1) / per != s) continue;   // a smaller split's slices
    const long long waves = ((long long)blocks * s + WSMS - 1) / WSMS;
    const long long cost = waves * (boxes + per);
    if (best < 0 || cost < best) {
      best = cost;
      *split = s;
      *cols = per * WBOX;
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Wait until at most n (0..3) of this warpgroup's groups are in flight.
__device__ __forceinline__ void wgmma_wait_upto(int n) {
  if (n >= 3)
    wgmma_wait<3>();
  else if (n == 2)
    wgmma_wait<2>();
  else if (n == 1)
    wgmma_wait<1>();
  else
    wgmma_wait<0>();
}

// ---------------------------------------------------------------------------
// attn_stats_wgmma: per kept row a, m_a and l_a over all S reduced rows
// (attention_tiles.cuh's definition: keys kept on the query axis, queries
// kept on the key axis; the launch swaps the maps), grid (S/64, B*H).
//
// The 64 kept rows are wgmma's M: both operands are then K-major along D,
// the kept tile A (64 x D, resident) and the reduced rows B, streamed as
// loads of 128 rows x 2 chunks (32 KB a stage; a chunk's 128 rows are
// 16 KB). Warpgroup w takes rows 64 w .. of every chunk: per chunk four
// m64n64k16 into its 64 x 64 fp32 scores (32 registers a thread; a tile's
// first step writes them, scale-d 0), one commit a load; it waits until
// only that group is in flight and releases the stage before. After a
// tile's last load it scales the scores by scale log2(e) and merges them
// into its rows' (m, l) on the accumulator fragments: lane 4 g + t holds
// rows g and g + 8 of its warp's 16, 16 scores each; a max and a sum of
// exp2 over the quad (__shfl_xor_sync 1, 2), then l <- l 2^(m - m') +
// sum 2^(s - m'). The two warpgroups' (m, l) merge through shared memory
// at the end; m stays in that scale (max of s scale log2(e)), which the
// apply takes as it is: the largest score's exponent is then exactly 0, as
// the reference's exp(s - max) is 1 there. Where S %
// 128 == 64 the last load's second half lies past S (TMA zero-fills it):
// warpgroup 1 multiplies it all the same and a select drops its scores.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(WTHREADS, 1)
attn_stats_wgmma(const __grid_constant__ CUtensorMap tm_kept,
                 const __grid_constant__ CUtensorMap tm_red, int heads, int S,
                 int D, int stages, float scale, float* __restrict__ m_out,
                 float* __restrict__ l_out) {
  extern __shared__ unsigned char smem_raw[];
  const int nl = wgmma_chunks(D) / WCHUNKS;    // loads of D
  unsigned char* kept = align1024(smem_raw);
  unsigned char* ring = kept + nl * kLoadBytes;   // [stages][2][128 x 64]
  float* merged = reinterpret_cast<float*>(ring + stages * 2 * kLoadBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(merged + 2 * 2 * WROWS);
  uint64_t* empty = full + stages;
  uint64_t* kept_bar = empty + stages;

  const int b = blockIdx.y, n = b / heads, hd = b % heads;
  const int a0 = blockIdx.x * WROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (S + WRED - 1) / WRED;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(kept_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // The producer: the kept tile, then load c of reduced tile t at ring
    // step it = t nl + c, once step it - stages has been released.
    if (lane == 0) {
      mbar_arrive_expect_tx(kept_bar, nl * kLoadBytes);
      for (int c = 0; c < nl; ++c)
        tma_load_chunks(kept + c * kLoadBytes, &tm_kept, kept_bar, a0,
                        c * WCHUNKS, hd, n);
      int it = 0;
      for (int t = 0; t < tiles; ++t)
        for (int c = 0; c < nl; ++c, ++it) {
          const int st = it % stages;
          if (it >= stages) mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * kLoadBytes);
          tma_load_chunks(ring + st * 2 * kLoadBytes, &tm_red, &full[st],
                          t * WRED, c * WCHUNKS, hd, n);
        }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
  float acc[32];
  const float scale2 = scale * kLog2e;
  mbar_wait(kept_bar, 0);
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    // Every warpgroup multiplies every load, past S too (zero rows there),
    // and drops those scores by a select: no wgmma, fence or wait may sit
    // in a branch on the warpgroup, or ptxas serializes them all.
    const bool live = t * WRED + wg * WROWS < S;
    for (int c = 0; c < nl; ++c, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < WCHUNKS; ++h) {
        const uint64_t da =
            wgmma_desc(kept + (c * WCHUNKS + h) * kChunkBytes);
        const uint64_t db = wgmma_desc(ring + st * 2 * kLoadBytes +
                                       h * 2 * kChunkBytes + wg * kChunkBytes);
#pragma unroll
        for (int kk = 0; kk < WBOX / 16; ++kk)
          wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, c + h + kk > 0);
      }
      wgmma_commit();
      wgmma_fence_operands(acc);
      // Load c - 1's group has retired: its stage is free.
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      if (c > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sc[16];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[2 * j + e] = __fmul_rn(acc[4 * j + 2 * hh + e], scale2);
          tmax = fmaxf(tmax, sc[2 * j + e]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mn = live ? fmaxf(m[hh], tmax) : m[hh];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) sum += exp2f(sc[i] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = live ? l[hh] * exp2f(m[hh] - mn) + sum : l[hh];
      m[hh] = mn;
    }
  }

  // Merge the two warpgroups' (m, l) of each kept row.
  float* mine = merged + wg * 2 * WROWS;   // [m, l][WROWS]
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mine[16 * w + g + 8 * hh] = m[hh];
      mine[WROWS + 16 * w + g + 8 * hh] = l[hh];
    }
  }
  named_barrier_sync(1, 256);
  if (threadIdx.x < WROWS) {
    const int r = threadIdx.x;
    const float m0 = merged[r], l0 = merged[WROWS + r];
    const float m1 = merged[2 * WROWS + r], l1 = merged[3 * WROWS + r];
    const float mm = fmaxf(m0, m1);
    m_out[(long long)b * S + a0 + r] = mm;
    l_out[(long long)b * S + a0 + r] =
        l0 * exp2f(m0 - mm) + l1 * exp2f(m1 - mm);
  }
}

// ---------------------------------------------------------------------------
// attn_apply_wgmma<QAXIS, NB, OUT>: out[i] = sum_j round_bf16(exp(s_ij -
// m) / l) v_j with the final stats of the pass above, grid (S/64, B*H,
// split); with OUT, the attention block's out[i] = (r_i W_out^T + b_out) +
// tokens_i instead (below).
//
// A block owns 64 queries (wgmma's M) and `cols` output columns at c0 =
// z cols, and walks all S/64 key tiles. The ring's stages are loads of
// 64 rows x 2 chunks (16 KB); a key tile is D/128 K loads, then the
// block's V loads (nv <= cols/64 chunks in nvl = ceil(nv / 2) loads).
//   scores  warpgroup w takes keys 32 w .. of the tile: per chunk four
//           m64n32k16, A the resident Q chunk, B the K chunk's rows 32 w ..
//           (both K-major), into 16 fp32 registers a thread (the tile's
//           first step writes them: scale-d 0);
//   P       on those fragments, 2^(s scale log2(e) - m) times 1/l in fp32
//           (m in the stats pass's log2 scale) with (m, 1/l) per query row
//           (key axis, two rows a thread, loaded once) or per key (query
//           axis, eight keys a thread, loaded per tile), rounded to bf16
//           (the reference's p.astype(v.dtype): normalised, then rounded)
//           and stored as bf16 pairs into a 64 x 64 P tile in the
//           128B-swizzled K-major
//           layout, two tiles in turn; a proxy fence and a named barrier of
//           the 256 consumer threads publish it (and show that the other
//           warpgroup's P V two tiles back, which read this buffer, has
//           retired);
//   P V     warpgroup w fills NB slots: slot b reads the block's V chunk
//           min(2 b + w, nv - 1), which lies in load min(b, nvl - 1); per
//           slot it waits for that load, then four m64n64k16 with A the
//           whole P tile (K-major, 16 keys a step) and B the V chunk read
//           MN-major (wgmma_desc_mn, the transpose-B bit: V is stored keys
//           x columns, so no transposed copy of V is made), one group a
//           slot into its own 64 x 64 fp32 accumulator. NB = ceil(cols /
//           128) is a template argument, so every wgmma, fence and wait runs
//           in every warpgroup, never under a branch on the warpgroup
//           (ptxas serializes all of a kernel's wgmma otherwise): where nv
//           is odd or short of 2 NB the last slots repeat chunk nv - 1 and
//           their sums are not stored.
// Register budget and the producer: a warpgroup's output is at most four
// chunks (256 columns), 128 fp32 registers a thread, beside 16 of scores:
// 190-210 in all. A block of nine warps (a producer warp beside the two
// warpgroups) caps every thread at 168, as three of its warps share one
// of the SM's four register files, and at four chunks ptxas then
// serializes the wgmma for want of registers (C7512). So the apply is two
// warpgroups alone (256 threads, up to 255 registers) and has no
// producer: thread 0 issues Q and the first `stages` loads, and after
// that each of the eight warps counts its release of a step in shared
// memory (atomicAdd), and the one that releases it last issues the load
// of step + stages into that stage. No thread waits to refill the ring: a
// thread that waited for the other warpgroup's releases would stall its
// own warpgroup's products. Two warpgroups
// share one P rather than split the columns across blocks, where each
// split would recompute Q K^T (6 S^2 D operations instead of 4 S^2 D at
// D = 512); wgmma_plan splits D = 768 and 1024 and the short grids
// (S = 64, 256) by cost.
// Slot b of both warpgroups reads load b, so each V load is released by
// both once their slot b (or the last slot repeating it) has retired; a
// warpgroup issues all its slots before it retires the first, so the ring
// holds a tile's V loads at once (at most 4 of its 5 stages at D = 1024,
// of 9 at D = 512) and the next tile's K loads come in as the slots retire.
// The epilogue rounds each accumulator pair to bf16 once, transposes four
// 8-column blocks across the quad (quad_transpose4) and stores 16 bytes a
// lane.
//
// The output projection (OUT, the attention block at D = C = 512, where the
// apply runs unsplit: NB = 4, the block's 64 rows of r whole in its two
// warpgroups). After the last key tile no wgmma reads Q any more (each
// warpgroup waited for its score products before the last P barrier), so
// r, rounded to bf16 (the reference's rounding point for r), is stored
// into Q's resident 64 KB in the same 128B-swizzled K-major layout as the
// P tile, published by a proxy fence and a named barrier. W_out (C x D,
// nn.Linear layout: its rows are the product's N, K-major) then streams
// through the same ring behind the last V loads, as loads of 128 rows x 64
// columns of K (16 KB): warpgroup w reads rows 64 w .. of each, so slot b
// of warpgroup w accumulates output chunk 2 b + w, r's own chunk, in the
// registers that held it. The loads walk K chunk by chunk, the four slots
// within each (C / 128 loads a chunk), so each output element sums its K
// in 16-deep steps in linear_wgmma's order. The epilogue is linear_wgmma's:
// b_out added in fp32, rounded to bf16, then the residual token added and
// rounded again (linear_reference's order), 16 bytes a lane. No r tensor
// exists. Every block reads all of W_out (512 KB) through L2: at (S, C) =
// (1024, 512), batch 16, 256 blocks read 128 MB from L2, where the
// three-launch route writes 16.8 MB of r to device memory and reads it
// back; and each block takes 32 more ring steps beside the attention's 128.
// ---------------------------------------------------------------------------

// The output projection's operands (OUT): W_out's TMA map in loads of 128
// rows x 64 columns, b_out (C floats or bf16, bias_dt), the residual tokens
// (N*S, C) and C. Zero for the apply alone.
struct OutProj {
  CUtensorMap w;
  const void* bias;
  const bf16* res;
  int bias_dt, C;
};

#define WOUT_ROWS 128   // W_out rows a load: 64 a warpgroup

template <bool QAXIS, int NB, bool OUT = false>
__global__ void __launch_bounds__(WAPPLY_THREADS, 1)
attn_apply_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ o, View ov, int heads, int S, int D,
                 int cols, int stages, float scale,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in,
                 const __grid_constant__ OutProj proj) {
  static_assert(!OUT || NB == 4, "the projection takes the unsplit D = 512");
  extern __shared__ unsigned char smem_raw[];
  const int nl = wgmma_chunks(D) / WCHUNKS;      // K loads a tile
  unsigned char* qs = align1024(smem_raw);       // [2 nl][64 x 64] Q
  unsigned char* ps = qs + nl * kLoadBytes;      // [2][64 x 64] P
  unsigned char* ring = ps + 2 * kChunkBytes;    // [stages][2][64 x 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kLoadBytes);
  uint64_t* q_bar = full + stages;
  int* released = reinterpret_cast<int*>(q_bar + 1);   // [stages]

  const int b = blockIdx.y, n = b / heads, hd = b % heads;
  const int i0 = blockIdx.x * WROWS;
  const int c0 = blockIdx.z * cols;
  const int nv = min(cols, D - c0) / WBOX;   // the block's V chunks
  const int nvl = (nv + WCHUNKS - 1) / WCHUNKS;
  const int steps = nl + nvl;                // ring steps a key tile
  const int tiles = S / WROWS, total = tiles * steps;
  // The projection's loads, after the attention's: C / 128 a K chunk.
  const int wloads = OUT ? proj.C / WOUT_ROWS : 0;
  const int all = total + (OUT ? wloads * (D / WBOX) : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Ring step x: K load i = x % steps of key tile x / steps, or (i >= nl)
  // the block's V load i - nl of it, or (x >= total) W_out's load of rows
  // 128 p .. and K chunk kc (x - total = kc wloads + p), into stage x %
  // stages.
  auto issue = [&](int x) {
    const int t = x / steps, i = x - t * steps, st = x % stages;
    mbar_arrive_expect_tx(&full[st], kLoadBytes);
    if (OUT && x >= total) {
      const int y = x - total, kc = y / wloads;
      tma_load_2d(ring + st * kLoadBytes, &proj.w, &full[st], kc * WBOX,
                  (y - kc * wloads) * WOUT_ROWS);
    } else if (i < nl)
      tma_load_chunks(ring + st * kLoadBytes, &tm_k, &full[st], t * WROWS,
                      i * WCHUNKS, hd, n);
    else
      tma_load_chunks(ring + st * kLoadBytes, &tm_v, &full[st], t * WROWS,
                      c0 / WBOX + (i - nl) * WCHUNKS, hd, n);
  };
  // No thread waits to refill the ring: each of the eight warps counts its
  // release of step x, and the one that releases it last (all products
  // that read the stage have retired) loads step x + stages there.
  auto release = [&](int x) {
    if (lane == 0 && atomicAdd(&released[x % stages], 1) == 7) {
      released[x % stages] = 0;
      if (x + stages < all) issue(x + stages);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(q_bar, nl * kLoadBytes);
    for (int c = 0; c < nl; ++c)
      tma_load_chunks(qs + c * kLoadBytes, &tm_q, q_bar, i0, c * WCHUNKS, hd,
                      n);
    for (int x = 0; x < stages && x < all; ++x) issue(x);
  }
  __syncthreads();

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, tg = lane & 3;
  const float scale2 = scale * kLog2e;
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  // Key axis: m (log2 scale) and 1/l of this lane's rows 16 w + g and
  // + 8, loaded once.
  float mrow[2] = {0.f, 0.f}, rlrow[2] = {1.f, 1.f};
  if (!QAXIS) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mrow[hh] = mb[i0 + 16 * w + g + 8 * hh];
      rlrow[hh] = __frcp_rn(lb[i0 + 16 * w + g + 8 * hh]);
    }
  }
  float acc[NB][32];
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[bi][i] = 0.f;
  float s[16];

  mbar_wait(q_bar, 0);
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * WROWS;
    // Query axis: m and l of this lane's keys j0 + 32 wg + 8 j + 2 tg (+1).
    float2 mk[4], lk[4];
    if (QAXIS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + 32 * wg + 8 * j + 2 * tg;
        mk[j] = *reinterpret_cast<const float2*>(mb + key);
        lk[j] = *reinterpret_cast<const float2*>(lb + key);
      }
    }
    for (int c = 0; c < nl; ++c, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      wgmma_fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < WCHUNKS; ++h) {
        const uint64_t da = wgmma_desc(qs + (c * WCHUNKS + h) * kChunkBytes);
        const uint64_t db = wgmma_desc(ring + st * kLoadBytes +
                                       h * kChunkBytes + wg * (kChunkBytes / 2));
#pragma unroll
        for (int kk = 0; kk < WBOX / 16; ++kk)
          wgmma_m64n32k16(s, da + 2 * kk, db + 2 * kk, c + h + kk > 0);
      }
      wgmma_commit();
      wgmma_fence_operands(s);
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      if (c > 0) release(it - 1);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    release(it - 1);

    // P into P tile t % 2: row r at byte 128 r, its 16-byte chunk c at
    // c ^ (r % 8); this lane's pair of keys 32 wg + 8 j + 2 tg sits in
    // chunk 4 wg + j at byte 4 tg, and r % 8 == g.
    unsigned char* pt = ps + (t & 1) * kChunkBytes;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float rq0 = QAXIS ? __frcp_rn(lk[j].x) : 0.f;
      const float rq1 = QAXIS ? __frcp_rn(lk[j].y) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // The scores rounded before the subtraction, as the stats pass and
        // the reference round them (no fused multiply-add).
        const float p0 = exp2f(__fmul_rn(s[4 * j + 2 * hh], scale2) -
                               (QAXIS ? mk[j].x : mrow[hh])) *
                         (QAXIS ? rq0 : rlrow[hh]);
        const float p1 = exp2f(__fmul_rn(s[4 * j + 2 * hh + 1], scale2) -
                               (QAXIS ? mk[j].y : mrow[hh])) *
                         (QAXIS ? rq1 : rlrow[hh]);
        const int row = 16 * w + g + 8 * hh;
        *reinterpret_cast<unsigned*>(pt + row * 128 +
                                     (((4 * wg + j) ^ g) << 4) + 4 * tg) =
            pack_bf16x2(p0, p1);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 256);

    const uint64_t dp = wgmma_desc(pt);
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int vc = min(2 * bi + wg, nv - 1), vl = vc / WCHUNKS;
      const int st = (it + vl) % stages;
      // A fence after each wait: a wgmma issued after the wait's loop
      // without one is serialized (ptxas puts its own fence in that path).
      mbar_wait(&full[st], ((it + vl) / stages) & 1);
      const uint64_t dv = wgmma_desc_mn(ring + st * kLoadBytes +
                                        (vc % WCHUNKS) * kChunkBytes);
      wgmma_fence_operands(acc[bi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WROWS / 16; ++kk)
        wgmma_m64n64k16_mn(acc[bi], dp + 2 * kk, dv + 128 * kk);
      wgmma_commit();
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) wgmma_fence_operands(acc[bi]);
    // Retire the slots' groups in turn, releasing each V load after the
    // last slot that reads it.
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      wgmma_wait_upto(NB - 1 - bi);
      const int vl = min(bi, nvl - 1);
      if (bi == NB - 1 || min(bi + 1, nvl - 1) != vl) release(it + vl);
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) wgmma_fence_operands(acc[bi]);
    it += nvl;
  }

  const int row0 = i0 + 16 * w + g;
  if constexpr (OUT) {
    // r (slot b: chunk 2 b + wg of it) rounded to bf16 into Q's buffer:
    // row r of chunk c at byte 128 r, its 16-byte unit j at j ^ (r % 8).
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      unsigned char* rt = qs + (2 * bi + wg) * kChunkBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<unsigned*>(rt + (16 * w + g + 8 * hh) * 128 +
                                       ((j ^ g) << 4) + 4 * tg) =
              pack_bf16x2(acc[bi][4 * j + 2 * hh], acc[bi][4 * j + 2 * hh + 1]);
    }
    fence_proxy_async();
    named_barrier_sync(1, 256);

    // out = r W_out^T: per K chunk kc, slot b takes load (kc, b), K-major
    // on both sides, into the registers r left, zeroed here, while no
    // wgmma is in flight (a wgmma with scale-d 0 in their place made ptxas
    // serialize every wgmma of the kernel, C7515).
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[bi][i] = 0.f;
    for (int kc = 0; kc < D / WBOX; ++kc) {
      const uint64_t da = wgmma_desc(qs + kc * kChunkBytes);
#pragma unroll
      for (int bi = 0; bi < NB; ++bi, ++it) {
        const int st = it % stages;
        mbar_wait(&full[st], (it / stages) & 1);
        const uint64_t dw =
            wgmma_desc(ring + st * kLoadBytes + wg * kChunkBytes);
        wgmma_fence_operands(acc[bi]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBOX / 16; ++kk)
          wgmma_m64n64k16(acc[bi], da + 2 * kk, dw + 2 * kk);
        wgmma_commit();
        wgmma_fence_operands(acc[bi]);
        // The previous load's group has retired: its stage is free.
        wgmma_wait<1>();
        wgmma_fence_operands(acc[bi]);
        if (kc + bi > 0) release(it - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) wgmma_fence_operands(acc[bi]);
    release(it - 1);

    // linear_wgmma's epilogue: b_out in fp32, rounded to bf16, then the
    // residual's eight values added and rounded again, 16 bytes a lane.
    const long long row_base = (long long)n * S + row0;
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int cbox = (2 * bi + wg) * WBOX;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        unsigned pk[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj, col = cbox + 8 * j + 2 * tg;
          const float b0 = sdm_load(proj.bias, col, proj.bias_dt);
          const float b1 = sdm_load(proj.bias, col + 1, proj.bias_dt);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pk[hh][jj] = pack_bf16x2(acc[bi][4 * j + 2 * hh] + b0,
                                     acc[bi][4 * j + 2 * hh + 1] + b1);
        }
        const int col8 = cbox + 32 * q + 8 * tg;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          quad_transpose4(pk[hh], tg);
          const long long e = (row_base + 8 * hh) * proj.C + col8;
          float v[8], r[8];
          unpack_bf16x8(pk[hh], v);
          sdm_load8(proj.res + e, r);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] += r[k];
          sdm_store8(o + e, v);
        }
      }
    }
    return;
  }

  // The epilogue: per four 8-column blocks, pairs rounded to bf16x2, a quad
  // transpose, and 16 bytes a lane (a warp writes 64 contiguous bytes a
  // row); a slot that repeats chunk nv - 1 stores nothing.
  bf16* op = o + (long long)n * ov.sn + (long long)hd * ov.sh;
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const bool store = 2 * bi + wg < nv;
    const int cbox = c0 + min(2 * bi + wg, nv - 1) * WBOX;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      unsigned pk[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          pk[hh][jj] = pack_bf16x2(acc[bi][4 * j + 2 * hh],
                                   acc[bi][4 * j + 2 * hh + 1]);
      }
      const int col8 = cbox + 32 * q + 8 * tg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        quad_transpose4(pk[hh], tg);
        if (store)
          *reinterpret_cast<uint4*>(op + (long long)(row0 + 8 * hh) * ov.ss +
                                    col8) =
              make_uint4(pk[hh][0], pk[hh][1], pk[hh][2], pk[hh][3]);
      }
    }
  }
}

typedef void (*wgmma_apply_fn)(CUtensorMap, CUtensorMap, CUtensorMap, bf16*,
                               View, int, int, int, int, int, float,
                               const float*, const float*, OutProj);

// The instantiation for `cols` output columns a block: NB = ceil(cols /
// 128) slots a warpgroup.
static wgmma_apply_fn wgmma_apply_kernel(int axis_q, int cols) {
  static const wgmma_apply_fn kernels[2][4] = {
      {&attn_apply_wgmma<false, 1>, &attn_apply_wgmma<false, 2>,
       &attn_apply_wgmma<false, 3>, &attn_apply_wgmma<false, 4>},
      {&attn_apply_wgmma<true, 1>, &attn_apply_wgmma<true, 2>,
       &attn_apply_wgmma<true, 3>, &attn_apply_wgmma<true, 4>}};
  return kernels[axis_q != 0][(cols + 2 * WBOX - 1) / (2 * WBOX) - 1];
}

// The TMA map of q, k or v (an (N, S, H, D) view) in loads of `rows` rows x
// WCHUNKS chunks.
static int wgmma_map(CUtensorMap* map, const bf16* p, View v, int batch,
                     int heads, int S, int D, int rows) {
  return sdm_tma_map_chunks(map, p, batch, S, heads, D, v.sn, v.ss, v.sh, rows,
                            WCHUNKS);
}

// The stats pass, then the apply. The maps are encoded here, per call (the
// pointers change every call), and travel as __grid_constant__ parameters.
// With OUT (the attention block at D = 512; `proj` its operands) the apply
// runs unsplit and carries the output projection: `out` is then the
// block's (N*S, C) output and views[3] is not read. Only the block's
// library instantiates that apply.
template <bool OUT = false>
static int launch_wgmma(const bf16* qp, const bf16* kp, const bf16* vp,
                        bf16* out, float* m, float* l, const View* views,
                        int bh, int heads, int S, int D, float scale,
                        int axis_q, cudaStream_t stream,
                        const OutProj& proj = OutProj{}) {
  const int batch = bh / heads;
  CUtensorMap tq, tk, tv, tred;
  int rc = wgmma_map(&tq, qp, views[0], batch, heads, S, D, WROWS);
  if (rc == 0) rc = wgmma_map(&tk, kp, views[1], batch, heads, S, D, WROWS);
  if (rc == 0) rc = wgmma_map(&tv, vp, views[2], batch, heads, S, D, WROWS);
  if (rc == 0)
    rc = axis_q ? wgmma_map(&tred, qp, views[0], batch, heads, S, D, WRED)
                : wgmma_map(&tred, kp, views[1], batch, heads, S, D, WRED);
  if (rc != 0) return rc;

  const size_t stats_smem = wgmma_stats_smem_bytes(D);
  cudaFuncSetAttribute(attn_stats_wgmma,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)stats_smem);
  attn_stats_wgmma<<<dim3(S / WROWS, bh), WTHREADS, stats_smem, stream>>>(
      axis_q ? tk : tq, tred, heads, S, D, wgmma_stats_stages(D), scale, m,
      l);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int split = 1, cols = D;
  wgmma_apply_fn kernel;
  if constexpr (OUT) {
    kernel = axis_q ? &attn_apply_wgmma<true, 4, true>
                    : &attn_apply_wgmma<false, 4, true>;
  } else {
    wgmma_plan(bh, S, D, &split, &cols);
    kernel = wgmma_apply_kernel(axis_q, cols);
  }
  const size_t apply_smem = wgmma_apply_smem_bytes(D);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)apply_smem);
  kernel<<<dim3(S / WROWS, bh, split), WAPPLY_THREADS, apply_smem, stream>>>(
      tq, tk, tv, out, views[3], heads, S, D, cols, wgmma_apply_stages(D),
      scale, m, l, proj);
  return (int)cudaGetLastError();
}

// The CUDA-core apply's output-column split, so a small grid still fills
// the card: about `target` blocks, each split a multiple of `cols` columns
// and at most max_cols (each split recomputes the scores).
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

// Whether attention_forward takes S: on the tensor-core path (tensor_cores
// != 0) S <= WHOLE_S_MAX_MMA, on the CUDA-core path when the apply pass's
// 32 x S block fits in shared memory.
static bool attention_fits(int S, int tensor_cores) {
  return tensor_cores ? S <= WHOLE_S_MAX_MMA : apply_smem_bytes(S) <= MAX_SMEM;
}

// The whole-S attention on the stream: q, k, v and out (batch, S, heads, D)
// views (views: their (sn, sh, ss)), stats the fp32 scratch of 2 batch heads
// S floats. Returns cudaGetLastError() after the launches (0 = success), or
// SDM_ERR_TOKENS, having launched nothing, when S is too long.
static int attention_forward(const void* q, const void* k, const void* v,
                             void* o, float* stats, const View* views,
                             int batch, int heads, int S, int D, float scale,
                             int axis_q, int dt, cudaStream_t stream) {
  const int bh = batch * heads;
  float* m = stats;
  float* l = stats + (long long)bh * S;
  const void* ptrs[4] = {q, k, v, o};
  const bool tc = wgmma_ok(dt, ptrs, views, S, D);
  if (!attention_fits(S, tc)) return SDM_ERR_TOKENS;
  if (tc)
    return launch_wgmma(static_cast<const bf16*>(q),
                        static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<bf16*>(o), m,
                        l, views, bh, heads, S, D, scale, axis_q, stream);
  if (dt == SDM_F32)
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), m, l,
                  views, bh, heads, S, D, scale, axis_q, stream);
  return launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o), m, l, views,
                bh, heads, S, D, scale, axis_q, stream);
}
