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
// The forward in bf16 at S % 64 == 0, D % 64 == 0, D <= 1024 with 16-byte
// aligned rows runs on TMA + wgmma: stream_stats_wgmma and
// stream_apply_wgmma (below), and so does the backward's dV pass, which is
// the apply pass with the roles swapped (stream_apply_wgmma<..., dv_pass>,
// at the same shapes), and its dK and dQ passes in bf16 at S % 64 == 0,
// D % 128 == 0, D <= 512 (stream_da_wgmma, below). fp32, and bf16 at other
// shapes, take CUDA-core kernels (fp32 FMA)
// that mask ragged tiles: keys past S give P = 0, and the stats count them
// as -inf. The apply pass is bound by operations: 4*S*S*D per (batch, head)
// (scores and P V), 2*S*S*D for the stats.
//
// q, k, v and out are (B, S, D) with arbitrary B and S strides and a unit D
// stride, so the attention block can pass views of its qkv buffer; m and l
// are (B, S) fp32. The apply pass writes out in the input dtype, or in fp32
// (the key-axis backward keeps the fp32 output as a residual).
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_tiles.cuh"

// Pass tags, so a profiler trace names the apply kernel's callers apart
// (stream_apply_wgmma<..., dv_pass> is the dV pass) and dK from dQ.
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

// ---------------------------------------------------------------------------
// The bf16 forward on Hopper's instruments: stream_stats_wgmma<KEPT>, then
// stream_apply_wgmma<QAXIS, OutT, NB, AC, Pass>, on TMA + wgmma
// (wgmma_tiles.cuh).
//
// They replace the TPU's _stats_kernel (sdm_tpu/kernels/streaming_attention
// .py:97, pallas_call at :223) and _apply_kernel (:120, pallas_call at
// :234), and the apply kernel with the roles swapped replaces _dv_kernel
// (:133, pallas_call at :298) as the backward's dV pass (see
// sdm_streaming_dv), for bf16 at S % 64 == 0, D % 64 == 0, 64 <= D <= 1024
// with 16-byte aligned rows and strides (sw_ok): the SR model's (4096, 512)
// block and every shape the whole-S path also takes. They compute what the two
// Pallas kernels compute, not their tiles. Both are bound by operations
// (2 S^2 D per batch row for the stats, 4 S^2 D for the apply, against
// 2 or 4 S D bf16 bytes in: at (4096, 512) about 2,000 operations a byte,
// far above the H100's ~295 for bf16), but every block streams the whole
// other operand through its SM's TMA unit, whose cost is mostly per load
// (tools/torch_attention_tiles.py: 8 KB loads at 3.3 TB/s over the card,
// 16 KB at 6.6, 32 KB at 7.6), and multicasting a load to a cluster of
// blocks does not lower what each SM receives (clusters of 2 and 4 blocks
// with TMA multicast of the streamed rows were slower at every shape the
// sweep took). So the design moves fewer and larger loads per product:
//   stats  128 kept rows a block where its ring keeps two stages (D <= 640;
//          else 64): warpgroup w owns kept rows 64 w .. and multiplies
//          them against all 128 reduced rows of each 32 KB load
//          (m64n128k16), twice the products a streamed byte of the
//          64-row block, in which both warpgroups share the kept rows and
//          split each load's reduced rows (m64n64k16) and merge their
//          (m, l) at the end. A producer warp keeps the ring full.
//   apply  64 queries a block (wgmma's M; 128 would need 256 fp32
//          accumulators a thread at D = 512), loads of eight chunks (a key
//          tile's whole K or V at D = 512, 64 KB) at 256 < D <= 512, else
//          four. Two warpgroups split the scores by keys and the output by
//          64-column chunks around one P tile, and refill the ring
//          themselves: no producer warp, so a thread may hold the output's
//          128 fp32 registers.
// Measured on the H100 at (4096, 512), batch 16, query axis
// (tools/torch_streaming_tiles.py): the stats 0.56 ms at 128 kept rows,
// 0.74 at 64; the apply 2.03 ms in loads of four chunks, 1.68 in eight;
// the ring's depth moved neither.
//
// The pipelines are the whole-S kernels' (attention.cu: attn_stats_wgmma,
// attn_apply_wgmma, whose comments give their reasons). What else differs:
//   m         the natural scale, as the reference's and as the backward
//             reads it (expf(s scale - m) / l): the stats keep max(s
//             scale), s scale rounded before the subtraction, and sum
//             2^((s scale - m) log2(e)); the apply forms P the same way;
//   output    bf16 (the main path) or fp32 (the key-axis training
//             residual), stored from the accumulator fragments.
// ---------------------------------------------------------------------------

#define SW_ROWS 64          // kept rows (stats) and queries (apply) a block
#define SW_BOX 64           // columns of D a chunk: one 128-byte row
#define SW_CHUNKS 2         // chunks a stats TMA load
#define SW_APPLY_CHUNKS 8   // chunks an apply TMA load at 256 < D <= 512
#define SW_APPLY_CHUNKS_S 4  // ... at other D
#define SW_MAX_D 1024       // widest D of the path
#define SW_COLS 512         // widest output-column slice of an apply block
#define SW_RED 128          // reduced rows a stats load: 64 a warpgroup
#define SW_STATS_STAGES 8   // most stats ring stages (128 rows x 2 chunks)
#define SW_APPLY_STAGES 16  // most apply ring stages
#define SW_STATS_THREADS 288  // two consumer warpgroups and a producer warp
#define SW_APPLY_THREADS 256  // two warpgroups that refill their ring
#define SW_STATS_KEPT 128   // kept rows a stats block, where they fit

static constexpr int kSwChunk = SW_ROWS * SW_BOX * 2;   // a 64 x 64 tile
static constexpr int kSwLoad = SW_CHUNKS * kSwChunk;
// Alignment slack (1024) and room for the barriers and counters (512).
static constexpr int kSwFixed = 1024 + 512;
static constexpr float kSwLog2e = 1.4426950408889634f;

// Chunks of D rounded up to whole loads of `per` chunks: the resident
// tile's size.
__host__ __device__ static inline int sw_chunks(int D, int per = SW_CHUNKS) {
  return (D / SW_BOX + per - 1) / per * per;
}

// The stats' shared memory besides the ring: the kept tile (`kept` = 64
// or 128 rows), and with 64 kept rows the two warpgroups' 64 (m, l) pairs.
static long long sw_stats_fixed(int D, int kept) {
  return kSwFixed + (kept == SW_ROWS ? 2 * 2 * SW_ROWS * 4 : 0) +
         (long long)sw_chunks(D) * kSwChunk * (kept / SW_ROWS);
}

// Ring stages where the shared memory leaves room: the stats' beside their
// kept tile (and (m, l) pairs), the apply's beside Q and two P tiles.
static int sw_stats_stages(int D, int kept) {
  const long long n = (MAX_SMEM - sw_stats_fixed(D, kept)) / (2 * kSwLoad);
  return (int)(n < SW_STATS_STAGES ? n : SW_STATS_STAGES);
}

// The apply's chunks a TMA load at D: SW_APPLY_CHUNKS (one load a key
// tile's K at 256 < D <= 512), else SW_APPLY_CHUNKS_S. The TMA unit costs
// about as much per load as per byte below 64 KB
// (tools/torch_streaming_tiles.py: at (4096, 512) the apply took 2.03 ms
// in loads of four chunks, 1.68 in eight).
static int sw_apply_chunks(int D) {
  return D > 4 * SW_BOX && D <= SW_COLS ? SW_APPLY_CHUNKS : SW_APPLY_CHUNKS_S;
}

static int sw_apply_stages(int D, int ac) {
  const long long room = MAX_SMEM - kSwFixed -
                         (long long)(sw_chunks(D, ac) + 2) * kSwChunk;
  const long long n = room / (ac * kSwChunk);
  return (int)(n < SW_APPLY_STAGES ? n : SW_APPLY_STAGES);
}

// The least apply ring: two stages (a K load retires while the next is
// read) and the V loads of a 512-column slice.
static int sw_apply_min_stages(int ac) {
  const int v = SW_COLS / SW_BOX / ac;
  return v > 2 ? v : 2;
}

static size_t sw_stats_smem_bytes(int D, int stages, int kept) {
  return (size_t)sw_stats_fixed(D, kept) + (size_t)stages * 2 * kSwLoad;
}

// The stats block's kept rows: SW_STATS_KEPT where its ring keeps two
// stages at D, else 64.
static int sw_stats_kept(int D) {
  return sw_stats_stages(D, SW_STATS_KEPT) >= 2 ? SW_STATS_KEPT : SW_ROWS;
}

static size_t sw_apply_smem_bytes(int D, int stages, int ac) {
  return kSwFixed + (size_t)(sw_chunks(D, ac) + 2) * kSwChunk +
         (size_t)stages * ac * kSwChunk;
}

// The admission of both kernels: bf16, S % 64 == 0, D % 64 == 0 with
// 64 <= D <= 1024, the stats' ring at least two stages and the apply's at
// least the four V loads of a 512-column slice, both within MAX_SMEM, and
// what TMA (and the epilogue's 16-byte stores) need of the n tensors:
// 16-byte aligned bases, B and S strides that are multiples of 8 elements.
static bool sw_ok(int dt, const void* const* ptrs, const View* views, int n,
                  int S, int D) {
  return dt == SDM_BF16 && S > 0 && S % SW_ROWS == 0 && D >= SW_BOX &&
         D % SW_BOX == 0 && D <= SW_MAX_D &&
         sw_stats_stages(D, SW_ROWS) >= 2 &&
         sw_apply_stages(D, sw_apply_chunks(D)) >=
             sw_apply_min_stages(sw_apply_chunks(D)) &&
         rows_aligned16(ptrs, views, n);
}

// The apply's column slices: `split` slices of `cols` columns (whole
// chunks, at most SW_COLS; at D <= 512 one slice).
static void sw_split(int D, int* split, int* cols) {
  const int boxes = D / SW_BOX;
  *split = (D + SW_COLS - 1) / SW_COLS;
  *cols = (boxes + *split - 1) / *split * SW_BOX;
}

// Phase clocks for tools/torch_streaming_tiles.py and tools/torch_da_tiles
// .py, which build this file a second time with -DSW_PHASE_CLOCKS: every
// thread reads clock64() at the kernels' phase boundaries (no branch, so
// the wgmma pipeline is compiled as without) and thread 0 of each block
// adds its cycles per phase to sw_phase_clocks[kernel][phase] (the
// forward's stats and apply) or da_phase_clocks[phase] (dK and dQ) at the
// end. Nothing otherwise.
#ifdef SW_PHASE_CLOCKS
__device__ unsigned long long sw_phase_clocks[2][8];
__device__ unsigned long long da_phase_clocks[8];   // stream_da_wgmma's
#define SW_CLOCKS_START    \
  long long sw_ph[8] = {}; \
  long long sw_t0 = clock64();
#define SW_CLOCK(i)                 \
  {                                 \
    const long long t_ = clock64(); \
    sw_ph[i] += t_ - sw_t0;         \
    sw_t0 = t_;                     \
  }
#define SW_CLOCKS_ADD(dst)                            \
  if (threadIdx.x == 0)                               \
    for (int i_ = 0; i_ < 8; ++i_)                    \
      atomicAdd(&(dst)[i_], (unsigned long long)sw_ph[i_]);
#define SW_CLOCKS_END(k) SW_CLOCKS_ADD(sw_phase_clocks[k])
#else
#define SW_CLOCKS_START
#define SW_CLOCK(i)
#define SW_CLOCKS_ADD(dst)
#define SW_CLOCKS_END(k)
#endif

__device__ __forceinline__ unsigned char* sw_align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Wait until at most n (0..3) of this warpgroup's groups are in flight.
__device__ __forceinline__ void sw_wait_upto(int n) {
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
// stream_stats_wgmma<KEPT>: per kept row a, m_a = max_r s_ar scale and
// l_a = sum_r exp(s_ar scale - m_a) over all S reduced rows (keys kept on
// the query axis, queries kept on the key axis; the launch swaps the
// maps), grid (S/KEPT, B).
//
// The kept rows are wgmma's M (A, resident, K-major, each block loads its
// own), the reduced rows B, streamed as loads of 128 rows x 2 chunks (32
// KB a stage). KEPT = 128: warpgroup w owns kept rows 64 w .. and takes
// all 128 reduced rows of every load, four m64n128k16 a chunk into its
// 64 x 128 fp32 scores; KEPT = 64 (attn_stats_wgmma's block): both own the
// 64 kept rows, warpgroup w takes reduced rows 64 w .. of every load, four
// m64n64k16 a chunk. One commit a load; a load is released once the next
// one's group is in flight. After a tile's last load each warpgroup merges
// its scores into its rows' (m, l) on the fragments (lane 4 g + t: rows g
// and g + 8 of its warp's 16; a max and a sum over the quad). Where S % 128
// == 64 the last load's second half lies past S (zero-filled): it is
// multiplied all the same, and a select drops those scores (KEPT = 128:
// the columns at or past S; 64: warpgroup 1's whole half), as it drops
// the kept rows past S of the last 128-row block. KEPT = 64 merges the two
// warpgroups' (m, l) through shared memory at the end. The producer
// lane waits for its stage's "empty" barrier (the 8 consumer warps), arms
// its "full" barrier with the stage's bytes and issues the load.
// ---------------------------------------------------------------------------

template <int KEPT>
__global__ void __launch_bounds__(SW_STATS_THREADS, 1)
stream_stats_wgmma(const __grid_constant__ CUtensorMap tm_kept,
                   const __grid_constant__ CUtensorMap tm_red, int S, int D,
                   int stages, float scale, float* __restrict__ m_out,
                   float* __restrict__ l_out) {
  // WIDE: each warpgroup its own 64 of the block's 128 kept rows against
  // all 128 reduced rows of a load (m64n128k16); else both warpgroups the
  // block's 64 kept rows, each against 64 of the reduced rows (m64n64k16).
  constexpr bool WIDE = KEPT == 2 * SW_ROWS;
  constexpr int N = WIDE ? SW_RED : SW_ROWS;     // reduced rows a warpgroup
  constexpr int kKeptChunk = KEPT * SW_BOX * 2;  // a kept chunk tile
  extern __shared__ unsigned char smem_raw[];
  const int nl = sw_chunks(D) / SW_CHUNKS;       // loads of D
  unsigned char* kept = sw_align1024(smem_raw);
  unsigned char* ring = kept + nl * SW_CHUNKS * kKeptChunk;
  float* merged = reinterpret_cast<float*>(ring + stages * 2 * kSwLoad);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(merged + (WIDE ? 0 : 2 * 2 * SW_ROWS));
  uint64_t* empty = full + stages;
  uint64_t* kept_bar = empty + stages;

  const int b = blockIdx.y;
  const int a0 = blockIdx.x * KEPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (S + SW_RED - 1) / SW_RED;
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
    // step it = t nl + c, once the 8 consumer warps have released step
    // it - stages ("empty").
    if (lane == 0) {
      mbar_arrive_expect_tx(kept_bar, nl * SW_CHUNKS * kKeptChunk);
      for (int c = 0; c < nl; ++c)
        tma_load_chunks(kept + c * SW_CHUNKS * kKeptChunk, &tm_kept, kept_bar,
                        a0, c * SW_CHUNKS, 0, b);
      int it = 0;
      for (int t = 0; t < tiles; ++t)
        for (int c = 0; c < nl; ++c, ++it) {
          const int st = it % stages;
          if (it >= stages) mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * kSwLoad);
          tma_load_chunks(ring + st * 2 * kSwLoad, &tm_red, &full[st],
                          t * SW_RED, c * SW_CHUNKS, 0, b);
        }
    }
    return;
  }

  // A consumer warp's release of stage st: one arrival on the "empty"
  // barrier.
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, tg = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
  float acc[N / 2];
  mbar_wait(kept_bar, 0);
  SW_CLOCKS_START
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    // Every warpgroup multiplies every load, past S too (zero rows there),
    // and drops those scores by a select: no wgmma, fence or wait may sit
    // in a branch on the warpgroup, or ptxas serializes them all. WIDE:
    // the reduced rows at or past `lim` of this tile; else warpgroup 1's
    // whole half where it lies past S.
    const bool live = WIDE || t * SW_RED + wg * SW_ROWS < S;
    const int lim = S - t * SW_RED;
    for (int c = 0; c < nl; ++c, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      SW_CLOCK(0)
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < SW_CHUNKS; ++h) {
        const uint64_t da =
            wgmma_desc(kept + (c * SW_CHUNKS + h) * kKeptChunk +
                       (WIDE ? wg * kSwChunk : 0));
        const uint64_t db =
            wgmma_desc(ring + st * 2 * kSwLoad + h * 2 * kSwChunk +
                       (WIDE ? 0 : wg * kSwChunk));
#pragma unroll
        for (int kk = 0; kk < SW_BOX / 16; ++kk) {
          if constexpr (WIDE)
            wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, c + h + kk > 0);
          else
            wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, c + h + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_fence_operands(acc);
      // Load c - 1's group has retired: its stage is free.
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      if (c > 0) release((it - 1) % stages);
      SW_CLOCK(1)
    }
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    release((it - 1) % stages);
    SW_CLOCK(2)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sc[N / 4];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = __fmul_rn(acc[4 * j + 2 * hh + e], scale);
          sc[2 * j + e] = !WIDE || 8 * j + 2 * tg + e < lim ? x : -INFINITY;
          tmax = fmaxf(tmax, sc[2 * j + e]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mn = live ? fmaxf(m[hh], tmax) : m[hh];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < N / 4; ++i) sum += exp2f((sc[i] - mn) * kSwLog2e);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = live ? l[hh] * exp2f((m[hh] - mn) * kSwLog2e) + sum : l[hh];
      m[hh] = mn;
    }
    SW_CLOCK(3)
  }
  SW_CLOCKS_END(0)

  if constexpr (WIDE) {
    // Each warpgroup's rows are its own: lane 4 g of each quad stores them
    // (rows past S, zero-filled kept rows of the last block, are not).
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = a0 + SW_ROWS * wg + 16 * w + g + 8 * hh;
        if (row < S) {
          m_out[(long long)b * S + row] = m[hh];
          l_out[(long long)b * S + row] = l[hh];
        }
      }
    }
  } else {
    // Merge the two warpgroups' (m, l) of each kept row.
    float* mine = merged + wg * 2 * SW_ROWS;   // [m, l][SW_ROWS]
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mine[16 * w + g + 8 * hh] = m[hh];
        mine[SW_ROWS + 16 * w + g + 8 * hh] = l[hh];
      }
    }
    named_barrier_sync(1, 256);
    if (threadIdx.x < SW_ROWS) {
      const int r = threadIdx.x;
      const float m0 = merged[r], l0 = merged[SW_ROWS + r];
      const float m1 = merged[2 * SW_ROWS + r], l1 = merged[3 * SW_ROWS + r];
      const float mm = fmaxf(m0, m1);
      m_out[(long long)b * S + a0 + r] = mm;
      l_out[(long long)b * S + a0 + r] = l0 * exp2f((m0 - mm) * kSwLog2e) +
                                         l1 * exp2f((m1 - mm) * kSwLog2e);
    }
  }
}

// ---------------------------------------------------------------------------
// stream_apply_wgmma<QAXIS, OutT, NB, AC, Pass>: out[i] = sum_j round_bf16(
// exp(s_ij scale - m) / l) v_j with the final (natural-scale) stats, grid
// (S/64, B, split). Pass tags the caller: apply_pass (the forward, bf16 or
// fp32 out) or dv_pass (dV = P^T g, fp32 out, launched with q and k
// swapped, so that its 64 own rows are keys and its streamed rows queries).
//
// attn_apply_wgmma's block, in loads of AC chunks: 64 queries (wgmma's M,
// Q resident) and `cols` output columns at c0 = z cols; a key tile is
// D/(64 AC) K loads, then the block's nvl V loads (64 rows x AC chunks, a
// stage); warpgroup w scores keys 32 w .. of each tile (four m64n32k16 a
// chunk), forms P on the fragments, 2^((s scale - m) log2(e)) times 1/l,
// with (m, 1/l) per query row (key axis, loaded once) or per key (query
// axis, loaded a tile ahead), rounds it to bf16 (normalised, then rounded)
// into one of two swizzled
// 64 x 64 P tiles, and after a proxy fence and a named barrier of the 256
// threads multiplies the whole P tile by its NB V chunks (slot b: chunk
// min(2 b + w, nv - 1), read MN-major through the transpose-B bit) into
// NB 64 x 64 fp32 accumulators. Every wgmma, fence and wait runs in both
// warpgroups (NB is a template argument; short slots repeat chunk nv - 1
// and store nothing). Two warpgroups alone, no producer warp (up to 255
// registers: four accumulators are 128 a thread): thread 0 arms the "full"
// barriers and issues Q and the first `stages` steps; after that lane 0 of
// each warp counts its release of step x on the counter of stage st = x %
// stages, and the release that completes the count arms that stage's
// barrier and issues step x + stages. The counters never reset: the u-th
// use of a stage is complete at 8 (u + 1) - 1.
// The epilogue stores bf16 pairs transposed across the quad (16 bytes a
// lane) or fp32 pairs.
// ---------------------------------------------------------------------------

template <bool QAXIS, typename OutT, int NB, int AC, typename Pass>
__global__ void __launch_bounds__(SW_APPLY_THREADS, 1)
stream_apply_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   OutT* __restrict__ o, View ov, int S, int D, int cols,
                   int stages, float scale,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kSwApplyLoad = AC * kSwChunk;    // AC chunks a load
  const int nl = sw_chunks(D, AC) / AC;          // K loads a tile
  unsigned char* qs = sw_align1024(smem_raw);    // [AC nl][64 x 64] Q
  unsigned char* ps = qs + nl * kSwApplyLoad;    // [2][64 x 64] P
  unsigned char* ring = ps + 2 * kSwChunk;       // [stages][AC][64 x 64]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + stages * kSwApplyLoad);
  uint64_t* q_bar = full + stages;
  // The warps' releases of each stage.
  unsigned* released = reinterpret_cast<unsigned*>(q_bar + 1);   // [stages]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * SW_ROWS;
  const int c0 = blockIdx.z * cols;
  const int nv = min(cols, D - c0) / SW_BOX;   // the block's V chunks
  const int nvl = (nv + AC - 1) / AC;
  const int steps = nl + nvl;                  // ring steps a key tile
  const int tiles = S / SW_ROWS, total = tiles * steps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Ring step x: K load i = x % steps of key tile x / steps, or (i >= nl)
  // the block's V load i - nl of it, into stage x % stages.
  auto load = [&](int x) {
    const int t = x / steps, i = x - t * steps, st = x % stages;
    if (i < nl)
      tma_load_chunks(ring + st * kSwApplyLoad, &tm_k, &full[st],
                      t * SW_ROWS, i * AC, 0, b);
    else
      tma_load_chunks(ring + st * kSwApplyLoad, &tm_v, &full[st],
                      t * SW_ROWS, c0 / SW_BOX + (i - nl) * AC, 0, b);
  };
  // No thread waits to refill the ring: the warp that releases step x last
  // arms the stage's barrier and loads step x + stages.
  auto release = [&](int x) {
    if (lane != 0) return;
    const int st = x % stages;
    const unsigned use = (unsigned)(x / stages + 1);
    if (atomicAdd(&released[st], 1u) != 8u * use - 1) return;
    if (x + stages >= total) return;
    mbar_arrive_expect_tx(&full[st], kSwApplyLoad);
    load(x + stages);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_bar, nl * kSwApplyLoad);
    for (int c = 0; c < nl; ++c)
      tma_load_chunks(qs + c * kSwApplyLoad, &tm_q, q_bar, i0, c * AC, 0, b);
    for (int x = 0; x < stages && x < total; ++x) {
      mbar_arrive_expect_tx(&full[x], kSwApplyLoad);
      load(x);
    }
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, tg = lane & 3;
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  // Key axis: m and 1/l of this lane's rows 16 w + g and + 8, loaded once.
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
  SW_CLOCKS_START
  // Query axis: m and l of this lane's keys j0 + 32 wg + 8 j + 2 tg (+1)
  // of key tile j0, loaded a tile ahead so that their latency hides behind
  // a tile's products (the last tile loads its own again).
  float2 mk[4], lk[4];
  auto load_key_stats = [&](int j0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = j0 + 32 * wg + 8 * j + 2 * tg;
      mk[j] = *reinterpret_cast<const float2*>(mb + key);
      lk[j] = *reinterpret_cast<const float2*>(lb + key);
    }
  };
  if (QAXIS) load_key_stats(0);
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    const int j0 = t * SW_ROWS;
    for (int c = 0; c < nl; ++c, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      SW_CLOCK(0)
      wgmma_fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < AC; ++h) {
        const uint64_t da = wgmma_desc(qs + (c * AC + h) * kSwChunk);
        const uint64_t db = wgmma_desc(ring + st * kSwApplyLoad + h * kSwChunk +
                                       wg * (kSwChunk / 2));
#pragma unroll
        for (int kk = 0; kk < SW_BOX / 16; ++kk)
          wgmma_m64n32k16(s, da + 2 * kk, db + 2 * kk, c + h + kk > 0);
      }
      wgmma_commit();
      wgmma_fence_operands(s);
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      if (c > 0) release(it - 1);
      SW_CLOCK(1)
    }
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    release(it - 1);
    SW_CLOCK(2)

    // P into P tile t % 2: row r at byte 128 r, its 16-byte chunk c at
    // c ^ (r % 8); this lane's pair of keys 32 wg + 8 j + 2 tg sits in
    // chunk 4 wg + j at byte 4 tg, and r % 8 == g.
    unsigned char* pt = ps + (t & 1) * kSwChunk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float rq0 = QAXIS ? __frcp_rn(lk[j].x) : 0.f;
      const float rq1 = QAXIS ? __frcp_rn(lk[j].y) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // The scores scaled and rounded before the subtraction, as the
        // stats pass and the reference round them (no fused multiply-add).
        const float p0 = exp2f((__fmul_rn(s[4 * j + 2 * hh], scale) -
                                (QAXIS ? mk[j].x : mrow[hh])) *
                               kSwLog2e) *
                         (QAXIS ? rq0 : rlrow[hh]);
        const float p1 = exp2f((__fmul_rn(s[4 * j + 2 * hh + 1], scale) -
                                (QAXIS ? mk[j].y : mrow[hh])) *
                               kSwLog2e) *
                         (QAXIS ? rq1 : rlrow[hh]);
        const int row = 16 * w + g + 8 * hh;
        *reinterpret_cast<unsigned*>(pt + row * 128 +
                                     (((4 * wg + j) ^ g) << 4) + 4 * tg) =
            pack_bf16x2(p0, p1);
      }
    }
    if (QAXIS) load_key_stats(min(j0 + SW_ROWS, S - SW_ROWS));
    fence_proxy_async();
    SW_CLOCK(3)
    named_barrier_sync(1, 256);
    SW_CLOCK(4)

    const uint64_t dp = wgmma_desc(pt);
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int vc = min(2 * bi + wg, nv - 1), vl = vc / AC;
      const int st = (it + vl) % stages;
      // A fence after each wait: a wgmma issued after the wait's loop
      // without one is serialized (ptxas puts its own fence in that path).
      mbar_wait(&full[st], ((it + vl) / stages) & 1);
      SW_CLOCK(5)
      const uint64_t dv = wgmma_desc_mn(ring + st * kSwApplyLoad +
                                        (vc % AC) * kSwChunk);
      wgmma_fence_operands(acc[bi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SW_ROWS / 16; ++kk)
        wgmma_m64n64k16_mn(acc[bi], dp + 2 * kk, dv + 128 * kk);
      wgmma_commit();
      SW_CLOCK(6)
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) wgmma_fence_operands(acc[bi]);
    // Retire the slots' groups in turn, releasing each V load after the
    // last slot that reads it (every load holds chunks of both parities,
    // so each warpgroup's slots read every load of the block).
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      sw_wait_upto(NB - 1 - bi);
      const int vl = min(2 * bi + wg, nv - 1) / AC;
      if (bi == NB - 1 || min(2 * bi + 2 + wg, nv - 1) / AC != vl)
        release(it + vl);
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) wgmma_fence_operands(acc[bi]);
    it += nvl;
    SW_CLOCK(7)
  }
  SW_CLOCKS_END(1)

  // The epilogue; a slot that repeats chunk nv - 1 stores nothing. bf16:
  // per four 8-column blocks, pairs rounded to bf16x2, a quad transpose,
  // and 16 bytes a lane (a warp writes 64 contiguous bytes a row). fp32:
  // each lane's pairs as they lie in the fragment (32 bytes a quad).
  OutT* op = o + (long long)b * ov.sn;
  const int row0 = i0 + 16 * w + g;
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const bool store = 2 * bi + wg < nv;
    const int cbox = c0 + min(2 * bi + wg, nv - 1) * SW_BOX;
    if constexpr (std::is_same<OutT, float>::value) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (store)
            *reinterpret_cast<float2*>(op +
                                       (long long)(row0 + 8 * hh) * ov.ss +
                                       cbox + 8 * j + 2 * tg) =
                make_float2(acc[bi][4 * j + 2 * hh],
                            acc[bi][4 * j + 2 * hh + 1]);
    } else {
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
            *reinterpret_cast<uint4*>(op +
                                      (long long)(row0 + 8 * hh) * ov.ss +
                                      col8) =
                make_uint4(pk[hh][0], pk[hh][1], pk[hh][2], pk[hh][3]);
        }
      }
    }
  }
}

template <typename OutT>
using sw_apply_fn = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, OutT*,
                             View, int, int, int, int, float, const float*,
                             const float*);

// The instantiation for `cols` output columns a block (NB = ceil(cols /
// 128) slots a warpgroup) in loads of `ac` chunks: SW_APPLY_CHUNKS_S at
// every NB, SW_APPLY_CHUNKS at the NB = 3, 4 of 256 < D <= 512 (null
// elsewhere).
template <typename OutT, typename Pass>
static sw_apply_fn<OutT> sw_apply_kernel(int axis_q, int cols, int ac) {
  constexpr int S_ = SW_APPLY_CHUNKS_S, W_ = SW_APPLY_CHUNKS;
  static const sw_apply_fn<OutT> narrow[2][4] = {
      {&stream_apply_wgmma<false, OutT, 1, S_, Pass>,
       &stream_apply_wgmma<false, OutT, 2, S_, Pass>,
       &stream_apply_wgmma<false, OutT, 3, S_, Pass>,
       &stream_apply_wgmma<false, OutT, 4, S_, Pass>},
      {&stream_apply_wgmma<true, OutT, 1, S_, Pass>,
       &stream_apply_wgmma<true, OutT, 2, S_, Pass>,
       &stream_apply_wgmma<true, OutT, 3, S_, Pass>,
       &stream_apply_wgmma<true, OutT, 4, S_, Pass>}};
  static const sw_apply_fn<OutT> wide[2][2] = {
      {&stream_apply_wgmma<false, OutT, 3, W_, Pass>,
       &stream_apply_wgmma<false, OutT, 4, W_, Pass>},
      {&stream_apply_wgmma<true, OutT, 3, W_, Pass>,
       &stream_apply_wgmma<true, OutT, 4, W_, Pass>}};
  const int nb = (cols + 2 * SW_BOX - 1) / (2 * SW_BOX);
  if (ac == S_) return narrow[axis_q != 0][nb - 1];
  return ac == W_ && nb >= 3 ? wide[axis_q != 0][nb - 3] : nullptr;
}

// The TMA map of a (B, S, D) view in loads of `rows` rows x `chunks`
// chunks: a rank-5 map with one head. `batch`, `S` and `D` are the
// extent TMA reads; boxes past it are zero-filled.
static int sw_map(CUtensorMap* map, const void* p, View v, int batch, int S,
                  int D, int rows, int chunks = SW_CHUNKS) {
  return sdm_tma_map_chunks(map, p, batch, S, 1, D, v.sn, v.ss, v.ss, rows,
                            chunks);
}

// stream_stats_wgmma<kept> (64 or 128 kept rows) with a ring of `stages`
// on the maps of the kept rows (rows of `kept`) and the reduced rows (rows
// of SW_RED), grid (S/kept, batch).
static int run_stats_wgmma(const CUtensorMap& tkept, const CUtensorMap& tred,
                           int kept, int batch, int S, int D, int stages,
                           float scale, float* m, float* l,
                           cudaStream_t stream) {
  auto kernel = kept == SW_ROWS ? &stream_stats_wgmma<SW_ROWS>
                                : &stream_stats_wgmma<2 * SW_ROWS>;
  const size_t smem = sw_stats_smem_bytes(D, stages, kept);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3((S + kept - 1) / kept, batch), SW_STATS_THREADS, smem,
           stream>>>(tkept, tred, S, D, stages, scale, m, l);
  return (int)cudaGetLastError();
}

// stream_apply_wgmma in loads of `ac` chunks (sw_apply_kernel has an
// instantiation for it at D) with a ring of `stages`, on the maps of q, k
// and v (rows of 64, `ac` chunks), grid (S/64, batch, split).
template <typename Pass, typename OutT>
static int run_apply_wgmma(const CUtensorMap* maps, int axis_q, OutT* o,
                           View ov, int batch, int S, int D, int stages,
                           int ac, float scale, const float* m,
                           const float* l, cudaStream_t stream) {
  int split, cols;
  sw_split(D, &split, &cols);
  const auto kernel = sw_apply_kernel<OutT, Pass>(axis_q, cols, ac);
  const size_t smem = sw_apply_smem_bytes(D, stages, ac);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / SW_ROWS, batch, split), SW_APPLY_THREADS, smem,
           stream>>>(maps[0], maps[1], maps[2], o, ov, S, D, cols, stages,
                     scale, m, l);
  return (int)cudaGetLastError();
}

// The stats pass on stream_stats_wgmma: keys kept on the query axis,
// queries on the key axis; sw_stats_kept's rows a block and the most
// stages that fit.
static int launch_stats_wgmma(const bf16* qp, View qv, const bf16* kp,
                              View kv, int batch, int S, int D, float scale,
                              int axis_q, float* m, float* l,
                              cudaStream_t stream) {
  const int kept = sw_stats_kept(D);
  CUtensorMap tkept, tred;
  int rc = sw_map(&tkept, axis_q ? kp : qp, axis_q ? kv : qv, batch, S, D,
                  kept);
  if (rc == 0)
    rc = sw_map(&tred, axis_q ? qp : kp, axis_q ? qv : kv, batch, S, D,
                SW_RED);
  if (rc != 0) return rc;
  return run_stats_wgmma(tkept, tred, kept, batch, S, D,
                         sw_stats_stages(D, kept), scale, m, l, stream);
}

// The apply kernel on stream_apply_wgmma, out in OutT (bf16 or fp32), in
// sw_apply_chunks's loads with the most stages that fit.
template <typename Pass, typename OutT>
static int launch_apply_wgmma(const bf16* qp, const bf16* kp, const bf16* vp,
                              OutT* o, const View* views, int batch, int S,
                              int D, float scale, int axis_q, const float* m,
                              const float* l, cudaStream_t stream) {
  const int ac = sw_apply_chunks(D);
  CUtensorMap maps[3];
  const bf16* ptrs[3] = {qp, kp, vp};
  for (int i = 0; i < 3; ++i) {
    const int rc = sw_map(&maps[i], ptrs[i], views[i], batch, S, D, SW_ROWS,
                          ac);
    if (rc != 0) return rc;
  }
  return run_apply_wgmma<Pass>(maps, axis_q, o, views[3], batch, S, D,
                               sw_apply_stages(D, ac), ac, scale, m, l,
                               stream);
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
  if (sw_ok(dt, ptrs, views, 2, S, D))
    return launch_stats_wgmma(static_cast<const bf16*>(q), views[0],
                              static_cast<const bf16*>(k), views[1], batch, S,
                              D, scale, axis_q, m, l, stream);
  if (dt == SDM_F32)
    return (int)launch_stats<streaming, float>(
        static_cast<const float*>(q), views[0], static_cast<const float*>(k),
        views[1], batch, 1, S, D, scale, axis_q, m, l, stream);
  return (int)launch_stats<streaming, bf16>(
      static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
      views[1], batch, 1, S, D, scale, axis_q, m, l, stream);
}

// The apply kernel for out[i] = sum_j round_v(P_ij) v_j with P from (q, k,
// m, l) on `axis_q`, the output in OutT: the forward's apply pass
// (apply_pass) and the dV pass (dv_pass: the roles swapped, see
// sdm_streaming_dv) on stream_apply_wgmma where sw_ok admits the four
// tensors, else on the CUDA-core kernel.
template <typename Pass, typename OutT>
static int launch_apply(const void* q, const void* k, const void* v, OutT* o,
                        const View* views, int batch, int S, int D,
                        float scale, int axis_q, const float* m,
                        const float* l, int dt, cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, o};
  if (sw_ok(dt, ptrs, views, 4, S, D))
    return launch_apply_wgmma<Pass>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), o, views, batch, S, D, scale, axis_q, m,
        l, stream);
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

// The admissions of stream_stats_wgmma (ptrs and strides of q, k) and
// stream_apply_wgmma (q, k, v, out; the dV pass: k, q, g, dv, though each
// tensor is checked alone), for the Python mirrors in
// kernels/streaming_attention.py (checked against these on the card).
SDM_EXPORT int sdm_streaming_stats_takes_wgmma(const void* const* ptrs,
                                               const long long* strides,
                                               int S, int D, int dt) {
  View views[2];
  read_views(strides, views, 2);
  return sw_ok(dt, ptrs, views, 2, S, D);
}

SDM_EXPORT int sdm_streaming_apply_takes_wgmma(const void* const* ptrs,
                                               const long long* strides,
                                               int S, int D, int dt) {
  View views[4];
  read_views(strides, views, 4);
  return sw_ok(dt, ptrs, views, 4, S, D);
}

// smem: four ints, the stats (at sw_stats_kept's rows) and the apply
// kernel's (in sw_apply_chunks's loads) dynamic shared memory at D with
// the most stages that fit, and those stages.
SDM_EXPORT int sdm_streaming_wgmma_smem(int D, int* smem) {
  const int kept = sw_stats_kept(D), ac = sw_apply_chunks(D);
  smem[0] = (int)sw_stats_smem_bytes(D, sw_stats_stages(D, kept), kept);
  smem[1] = (int)sw_apply_smem_bytes(D, sw_apply_stages(D, ac), ac);
  smem[2] = sw_stats_stages(D, kept);
  smem[3] = sw_apply_stages(D, ac);
  return 0;
}

// plan: four ints, sw_split's (split, cols), sw_stats_kept and
// sw_apply_chunks at D.
SDM_EXPORT int sdm_streaming_wgmma_plan(int D, int* plan) {
  sw_split(D, plan, plan + 1);
  plan[2] = sw_stats_kept(D);
  plan[3] = sw_apply_chunks(D);
  return 0;
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
//       keys (the block owns 64 of them on wgmma, 32 on the CUDA cores),
//       its "keys" the queries, its values g, and the stats travel with the
//       other index: sum_i P^T_ji g_i is the apply pass's sum over the
//       streamed rows. Output in fp32. On the query axis (the SR model's)
//       its stats are per own row, loaded once a block, as the forward's
//       key-axis apply loads them.
//   dK, dQ: one kernel for out_a = scale sum_b round(dA_ab) B_b: the block
//       owns rows a of A (and of A2), streams tiles of rows b of B and B2,
//       forms the score tile A B^T and the tile A2 B2^T, turns them into dA,
//       rounds it and accumulates dA B. dQ is A = q, A2 = g, B = k, B2 = v;
//       dK is A = k, A2 = v, B = q, B2 = g (the transposed tiles: k_j . q_i
//       is the same score and v_j . g_i the same g_i . v_j).
//
// Each pass is bound by operations: per (batch, head) 4*S*S*D for dV (the
// scores and P^T g) and 6*S*S*D for dK and for dQ (scores, g V^T, dA B).
// dV takes stream_apply_wgmma<..., dv_pass> where sw_ok admits it, dK and
// dQ take stream_da_wgmma (below) where da_wgmma_ok admits them; fp32, and
// bf16 at other shapes, run stream_apply and stream_da on the CUDA cores
// with ragged tiles masked (P = 0 and dA = 0 outside S).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// The bf16 dK and dQ passes on Hopper's instruments: stream_da_wgmma<
// STAT_COL, Pass, NB>, on TMA + wgmma (wgmma_tiles.cuh).
//
// Replaces the TPU's _dk_kernel (sdm_tpu/kernels/streaming_attention.py:152,
// pallas_call at :260) and _dq_kernel (:167, pallas_call at :271) for bf16
// at S % 64 == 0, D % 128 == 0, D <= 512 with 16-byte aligned rows and
// strides of all five tensors (da_wgmma_ok): every U-Net shape that streams.
// It computes what the two Pallas kernels compute, not their tiles: out_a =
// scale sum_b round_bf16(dA_ab) B_b with dA = P (A2 B2^T - corr), P =
// exp(s scale - m) / l and s = A B^T (the roles above). Bound: operations,
// 6 S^2 D a batch row (A B^T, A2 B2^T, dA B), against 4 S D bf16 bytes in
// and 4 S D fp32 bytes out: at (4096, 512) about 1,500 operations a byte,
// far above the H100's ~295 for bf16.
//
// What decides the design is shared memory at D = 512. A block owns 64 rows
// of A and A2 (wgmma's M), resident: 128 KB of the 227. A streamed tile of
// 64 rows of B and B2 is 128 KB more, and B is read twice: K-major by the
// scores and MN-major by dA B, which can start only once the contraction
// over all of D is done. Holding a tile's B from its scores to its dA B
// leaves no room to load the next tile's B ahead (stream_da_mma, the
// mma.sync kernel this replaces, held 16-row tiles instead: n16 products,
// two barriers and a partial-score exchange every 16 streamed rows). Here
// every load is read by one phase alone, so the ring is a plain FIFO that
// keeps loads in flight through both phases. A tile is 3 NL ring steps,
// each a TMA load of DA_TILE rows x da_load_chunks(D) chunks (32 KB: NL = 2
// at D = 512):
//   scores  B load i, then B2 load i, i = 0 .. NL - 1;
//   dA B    B load i again (from L2), i = 0 .. NL - 1:
// half again the bytes of a B held whole, for a ring that never drains.
//
// Block: 64 own rows, grid (S/64, B), two warpgroups that refill their ring
// themselves (256 threads, one block an SM): no producer warp, so that a
// thread may hold 255 registers (the output's 128 fp32 accumulators, the
// two score fragments, the stats; with a ninth warp ptxas allows 168 and
// spills). Shared memory at D = 512: A and A2 128 KB, two dA tiles 16 KB,
// the staged stats 1.5 KB, two ring stages of 32 KB, 216,064 bytes in all.
//   scores  warpgroup w takes streamed rows 32 w .. of each tile: s = A B^T
//           and dp = A2 B2^T in two m64n32 fp32 accumulators (four
//           m64n32k16 a chunk, both operands K-major), one group a ring
//           step, retired and released before the next step's wait;
//   dA      on the fragments: p = 2^((s scale - m) log2(e)) (1/l) with the
//           scores scaled and rounded before the subtraction and m in the
//           natural scale, as the stats pass writes it (with STAT_COL the
//           stats of the tile's streamed rows, fetched a tile ahead and
//           staged in shared memory with one reciprocal a row; else the
//           lane's own rows', loaded once); p (dp - corr) rounded to
//           bf16 into a swizzled 64 x 64 dA tile (two, by tile parity, so a
//           warpgroup may write the next while the other still reads this
//           one); a proxy fence and a named barrier of the 256 threads;
//   dA B    warpgroup w owns output chunks 2 b + w (b < NB = D/128): the
//           whole dA tile (K-major) by that chunk of B (MN-major, the
//           transpose-B bit) into NB 64 x 64 fp32 accumulators, four
//           m64n64k16 a chunk, one group a slot, retired before the next
//           slot's wait; a load is released after its last slot (both
//           warpgroups' slot b lie in load 2 b / da_load_chunks(D)).
// No phase holds a stage while it waits for a load, so both stages of the
// ring are in flight then: the kernel is bound by the latency of its TMA
// loads more than by their bytes (tools/torch_da_tiles.py on an H100 SXM
// at 700 W: holding a (B, B2) pair and every dA B load at once left the
// block waiting for loads 38 % of its time; holding one step until the
// next had landed, 41 % at two stages of 32 KB, and each pass took 3.0 ms
// at (16, 4096, 512) against 2.5 ms now).
// Thread 0 issues A, A2 and the first `stages` steps; after that lane 0
// of each warp counts its release of step x on the counter of stage x %
// stages, and the release that completes the count arms that stage's
// "full" barrier and issues step x + stages. The epilogue scales
// and stores fp32 pairs from the fragments. Every sum runs in one fixed
// order, so two runs give the same bits. tools/torch_da_tiles.py builds
// this file with DA_TILE 32 (m64n16 score tiles) and DA_LOAD_CHUNKS 2 as
// well, and times them with stream_da_mma.
// ---------------------------------------------------------------------------

#ifndef DA_TILE
#define DA_TILE 64          // streamed rows a tile (32: m64n16 score tiles)
#endif
#ifndef DA_LOAD_CHUNKS
#define DA_LOAD_CHUNKS 4    // chunks a TMA load where they divide D's, else 2
#endif
#define DA_ROWS 64          // own rows a block: wgmma's M
#define DA_MAX_D 512        // widest D: four accumulators a warpgroup
#define DA_STAGES 16        // most ring stages
#define DA_THREADS 256      // two warpgroups, no producer warp

static_assert((DA_TILE == 64 || DA_TILE == 32) && DA_LOAD_CHUNKS % 2 == 0,
              "stream_da_wgmma tiling");
static constexpr int kDaChunk = DA_TILE * SW_BOX * 2;    // a streamed chunk
// The staged stats of two streamed tiles: m, 1/l and corr a row.
static constexpr int kDaStats = 2 * 3 * DA_TILE * 4;

// Chunks a TMA load at D: DA_LOAD_CHUNKS where they divide D's chunks
// (D = 256, 512), else two (tools/torch_da_tiles.py on an H100 SXM at
// 700 W, (16, 4096, 512): loads of four chunks in two stages 2.46-2.51 ms
// a pass, of two in five 3.42-3.64).
__host__ __device__ constexpr int da_load_chunks(int D) {
  return (D / SW_BOX) % DA_LOAD_CHUNKS == 0 ? DA_LOAD_CHUNKS : 2;
}

// Loads of D.
__host__ __device__ static inline int da_loads(int D) {
  return D / SW_BOX / da_load_chunks(D);
}

// The shared memory besides the ring: A and A2 (64 rows), the two dA
// tiles and the staged stats, with the alignment slack and the barriers.
static long long da_fixed(int D) {
  return kSwFixed + 2LL * (D / SW_BOX) * kSwChunk + 2LL * kSwChunk +
         kDaStats;
}

// The most ring stages that fit beside them, at most DA_STAGES.
static int da_stages(int D) {
  const long long n =
      (MAX_SMEM - da_fixed(D)) / (da_load_chunks(D) * kDaChunk);
  return (int)(n < DA_STAGES ? n : DA_STAGES);
}

static size_t da_smem_bytes(int D, int stages) {
  return (size_t)da_fixed(D) + (size_t)stages * da_load_chunks(D) * kDaChunk;
}


// stream_da_wgmma's admission: bf16, S % 64 == 0, D % 128 == 0 with
// D <= 512, a ring of at least two stages within MAX_SMEM (each phase
// holds a step while it waits for the next), and what TMA and the
// epilogue's 8-byte stores need of A, A2, B, B2 and out: 16-byte aligned
// bases, B and S strides that are multiples of 8 elements.
static bool da_wgmma_ok(int dt, const void* const* ptrs, const View* views,
                        int S, int D) {
  return dt == SDM_BF16 && S > 0 && S % DA_ROWS == 0 && S % DA_TILE == 0 &&
         D > 0 && D % 128 == 0 && D <= DA_MAX_D && da_stages(D) >= 2 &&
         rows_aligned16(ptrs, views, 5);
}

// The scores' m64nNk16 at N = DA_TILE / 2 streamed rows a warpgroup.
template <int N>
__device__ __forceinline__ void da_score(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 32)
    wgmma_m64n32k16(d, da, db, accumulate);
  else
    wgmma_m64n16k16(d, da, db, accumulate);
}

template <bool STAT_COL, typename Pass, int NB>
__global__ void __launch_bounds__(DA_THREADS, 1)
stream_da_wgmma(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_a2,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_b2,
                float* __restrict__ o, View ov, int S, int stages,
                float scale, const float* __restrict__ m_in,
                const float* __restrict__ l_in,
                const float* __restrict__ c_in) {
  constexpr int LC = da_load_chunks(128 * NB);  // chunks a load
  constexpr int kDaLoad = LC * kDaChunk;        // a ring stage
  constexpr int HN = DA_TILE / 2;               // streamed rows a warpgroup
  constexpr int SF = HN / 2;                    // its score fragment
  constexpr int NL = 2 * NB / LC;               // loads of D
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = sw_align1024(smem_raw);   // [2 NB][64 x 64] A
  unsigned char* a2s = as + 2 * NB * kSwChunk;       // A2
  unsigned char* dts = a2s + 2 * NB * kSwChunk;      // [2][64 x 64] dA
  unsigned char* ring = dts + 2 * kSwChunk;     // [stages][LC][TILE x 64]
  // STAT_COL: [2][m, 1/l, corr][DA_TILE] of a tile's streamed rows.
  float* stat_s = reinterpret_cast<float*>(ring + stages * kDaLoad);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat_s + 2 * 3 * DA_TILE);
  uint64_t* own_bar = full + stages;
  // The warps' releases of each stage.
  unsigned* released = reinterpret_cast<unsigned*>(own_bar + 1);  // [stages]

  const int b = blockIdx.y;
  const int a0 = blockIdx.x * DA_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = S / DA_TILE, total = tiles * 3 * NL;

  // Ring step x = 3 NL t + s of streamed tile t: B load s / 2 (s even) or
  // B2 load s / 2 (odd) for s < 2 NL, else B load s - 2 NL, into stage x %
  // stages.
  auto load = [&](int x) {
    const int t = x / (3 * NL), s = x - t * 3 * NL, st = x % stages;
    const bool second = s < 2 * NL && (s & 1);
    const int i = s < 2 * NL ? s >> 1 : s - 2 * NL;
    mbar_arrive_expect_tx(&full[st], kDaLoad);
    tma_load_chunks(ring + st * kDaLoad, second ? &tm_b2 : &tm_b, &full[st],
                    t * DA_TILE, i * LC, 0, b);
  };
  // No thread waits to refill the ring: the warp that releases step x last
  // loads step x + stages. The counters never reset: the u-th use of a
  // stage is complete at 8 (u + 1) - 1.
  auto release = [&](int x) {
    if (lane != 0) return;
    const int st = x % stages;
    const unsigned use = (unsigned)(x / stages + 1);
    if (atomicAdd(&released[st], 1u) != 8u * use - 1) return;
    if (x + stages < total) load(x + stages);
  };
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const float* cb = c_in + (long long)b * S;
  // STAT_COL: the m, 1/l and corr of streamed tile t, fetched by the first
  // DA_TILE threads at the start of tile t - 1 (so that the loads land
  // during its products) and staged into buffer t % 2 before its named
  // barrier: one reciprocal a row, not one a lane.
  float next_m = 0.f, next_l = 1.f, next_c = 0.f;
  auto fetch_stats = [&](int t) {
    if (threadIdx.x < DA_TILE && t < tiles) {
      const int key = t * DA_TILE + threadIdx.x;
      next_m = mb[key];
      next_l = lb[key];
      next_c = cb[key];
    }
  };
  auto stage_stats = [&](int t) {
    if (threadIdx.x < DA_TILE && t < tiles) {
      float* dst = stat_s + (t & 1) * 3 * DA_TILE + threadIdx.x;
      dst[0] = next_m;
      dst[DA_TILE] = __frcp_rn(next_l);
      dst[2 * DA_TILE] = next_c;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(own_bar, 1);
    mbar_fence_init();
  }
  if (STAT_COL) {
    fetch_stats(0);
    stage_stats(0);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(own_bar, 2 * NL * LC * kSwChunk);
    for (int c = 0; c < NL; ++c) {
      tma_load_chunks(as + c * LC * kSwChunk, &tm_a, own_bar, a0, c * LC, 0,
                      b);
      tma_load_chunks(a2s + c * LC * kSwChunk, &tm_a2, own_bar, a0, c * LC,
                      0, b);
    }
    for (int x = 0; x < stages && x < total; ++x) load(x);
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, tg = lane & 3;
  // Own-row stats: m, 1/l and corr of this lane's rows 16 w + g and + 8.
  float mrow[2] = {0.f, 0.f}, rlrow[2] = {1.f, 1.f}, crow[2] = {0.f, 0.f};
  if (!STAT_COL) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = a0 + 16 * w + g + 8 * hh;
      mrow[hh] = mb[row];
      rlrow[hh] = __frcp_rn(lb[row]);
      crow[hh] = cb[row];
    }
  }
  float acc[NB][32];
#pragma unroll
  for (int bi = 0; bi < NB; ++bi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[bi][i] = 0.f;
  float s[SF], dp[SF];

  mbar_wait(own_bar, 0);
  SW_CLOCKS_START
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    if (STAT_COL) fetch_stats(t + 1);
    // Step 2 i: s (+)= A_i B_i^T, step 2 i + 1: dp (+)= A2_i B2_i^T, one
    // group each, retired and released before the next step's wait, so
    // that no stage is held while a load is awaited.
#pragma unroll
    for (int i = 0; i < 2 * NL; ++i, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      SW_CLOCK(0)
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < LC; ++h) {
        const uint64_t da = wgmma_desc((i & 1 ? a2s : as) +
                                       ((i >> 1) * LC + h) * kSwChunk);
        const uint64_t db = wgmma_desc(ring + st * kDaLoad + h * kDaChunk +
                                       wg * (kDaChunk / 2));
#pragma unroll
        for (int kk = 0; kk < SW_BOX / 16; ++kk) {
          if (i & 1)
            da_score<HN>(dp, da + 2 * kk, db + 2 * kk, (i >> 1) + h + kk > 0);
          else
            da_score<HN>(s, da + 2 * kk, db + 2 * kk, (i >> 1) + h + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      wgmma_wait<0>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      release(it);
      SW_CLOCK(1)
    }

    // dA into dA tile t % 2: row r at byte 128 r, its 16-byte chunk c at
    // c ^ (r % 8); this lane's pair of streamed rows HN wg + 8 j + 2 tg
    // sits in chunk (HN / 8) wg + j at byte 4 tg, and r % 8 == g.
    unsigned char* dt = dts + (t & 1) * kSwChunk;
    const float* sst = stat_s + (t & 1) * 3 * DA_TILE;
#pragma unroll
    for (int j = 0; j < SF / 4; ++j) {
      // STAT_COL: this lane's streamed rows HN wg + 8 j + 2 tg (+ 1).
      float2 mk, rq, ck;
      if (STAT_COL) {
        const int col = HN * wg + 8 * j + 2 * tg;
        mk = *reinterpret_cast<const float2*>(sst + col);
        rq = *reinterpret_cast<const float2*>(sst + DA_TILE + col);
        ck = *reinterpret_cast<const float2*>(sst + 2 * DA_TILE + col);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // The scores scaled and rounded before the subtraction, as the
        // stats pass and the reference round them (no fused multiply-add).
        const float p0 = exp2f((__fmul_rn(s[4 * j + 2 * hh], scale) -
                                (STAT_COL ? mk.x : mrow[hh])) *
                               kSwLog2e) *
                         (STAT_COL ? rq.x : rlrow[hh]);
        const float p1 = exp2f((__fmul_rn(s[4 * j + 2 * hh + 1], scale) -
                                (STAT_COL ? mk.y : mrow[hh])) *
                               kSwLog2e) *
                         (STAT_COL ? rq.y : rlrow[hh]);
        const float x0 = p0 * (dp[4 * j + 2 * hh] -
                               (STAT_COL ? ck.x : crow[hh]));
        const float x1 = p1 * (dp[4 * j + 2 * hh + 1] -
                               (STAT_COL ? ck.y : crow[hh]));
        const int row = 16 * w + g + 8 * hh;
        *reinterpret_cast<unsigned*>(
            dt + row * 128 + ((((HN / 8) * wg + j) ^ g) << 4) + 4 * tg) =
            pack_bf16x2(x0, x1);
      }
    }
    if (STAT_COL) stage_stats(t + 1);
    fence_proxy_async();
    SW_CLOCK(3)
    named_barrier_sync(1, 256);
    SW_CLOCK(4)

    // Slot b of both warpgroups lies in load 2 b / LC; each slot is
    // retired before the next one's wait, and a load released after its
    // last slot.
    const uint64_t dd = wgmma_desc(dt);
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int oc = 2 * bi + wg, x = it + oc / LC, st = x % stages;
      // A fence after each wait: a wgmma issued after the wait's loop
      // without one is serialized (ptxas puts its own fence in that path).
      mbar_wait(&full[st], (x / stages) & 1);
      SW_CLOCK(5)
      const uint64_t dv =
          wgmma_desc_mn(ring + st * kDaLoad + (oc % LC) * kDaChunk);
      wgmma_fence_operands(acc[bi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DA_TILE / 16; ++kk)
        wgmma_m64n64k16_mn(acc[bi], dd + 2 * kk, dv + 128 * kk);
      wgmma_commit();
      wgmma_fence_operands(acc[bi]);
      wgmma_wait<0>();
      wgmma_fence_operands(acc[bi]);
      if (bi == NB - 1 || (2 * bi + 2) / LC != (2 * bi) / LC)
        release(it + (2 * bi) / LC);
      SW_CLOCK(6)
    }
    it += NL;
  }
  SW_CLOCKS_ADD(da_phase_clocks)

  // The epilogue: each lane's fp32 pairs as they lie in the fragment,
  // times scale (32 bytes a quad).
  float* op = o + (long long)b * ov.sn;
  const int row0 = a0 + 16 * w + g;
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const int cbox = (2 * bi + wg) * SW_BOX;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(op + (long long)(row0 + 8 * hh) * ov.ss +
                                   cbox + 8 * j + 2 * tg) =
            make_float2(acc[bi][4 * j + 2 * hh] * scale,
                        acc[bi][4 * j + 2 * hh + 1] * scale);
  }
}

using da_wgmma_fn = void (*)(CUtensorMap, CUtensorMap, CUtensorMap,
                             CUtensorMap, float*, View, int, int, float,
                             const float*, const float*, const float*);

// The instantiation for D = 128 NB on the stats' layout.
template <typename Pass>
static da_wgmma_fn da_wgmma_kernel(bool stat_col, int D) {
  static const da_wgmma_fn kernels[2][4] = {
      {&stream_da_wgmma<false, Pass, 1>, &stream_da_wgmma<false, Pass, 2>,
       &stream_da_wgmma<false, Pass, 3>, &stream_da_wgmma<false, Pass, 4>},
      {&stream_da_wgmma<true, Pass, 1>, &stream_da_wgmma<true, Pass, 2>,
       &stream_da_wgmma<true, Pass, 3>, &stream_da_wgmma<true, Pass, 4>}};
  return kernels[stat_col][D / 128 - 1];
}

// stream_da_wgmma with a ring of `stages` on the maps of A and A2 (rows of
// 64) and B and B2 (rows of DA_TILE), in loads of da_load_chunks(D) chunks,
// grid (S/64, batch). ptrs and views: A, A2, B, B2, out.
template <typename Pass>
static int launch_da_wgmma(const void* const* ptrs, const View* views,
                           float* o, int batch, int S, int D, int stages,
                           float scale, bool stat_col, const float* m,
                           const float* l, const float* c,
                           cudaStream_t stream) {
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int rc = sw_map(&maps[i], ptrs[i], views[i], batch, S, D,
                          i < 2 ? DA_ROWS : DA_TILE, da_load_chunks(D));
    if (rc != 0) return rc;
  }
  const auto kernel = da_wgmma_kernel<Pass>(stat_col, D);
  const size_t smem = da_smem_bytes(D, stages);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / DA_ROWS, batch), DA_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], o, views[4], S, stages, scale, m,
      l, c);
  return (int)cudaGetLastError();
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
  if (da_wgmma_ok(dt, ptrs, views, S, D))
    return launch_da_wgmma<Pass>(ptrs, views, o, batch, S, D, da_stages(D),
                                 scale, stat_col, m, l, c, stream);
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

// stream_da_wgmma's admission, dynamic shared memory and ring stages, for
// the Python mirrors (checked against these on the card). ptrs and strides:
// A, A2, B, B2 and out (any order: each tensor is checked alone).
SDM_EXPORT int sdm_streaming_da_takes_wgmma(const void* const* ptrs,
                                            const long long* strides, int S,
                                            int D, int dt) {
  View views[5];
  read_views(strides, views, 5);
  return da_wgmma_ok(dt, ptrs, views, S, D);
}

// smem: two ints, the dynamic shared memory at D with the most stages that
// fit and those stages; (0, 0) at a D off the kernel's grid (D % 128 != 0
// or D > 512).
SDM_EXPORT int sdm_streaming_da_wgmma_smem(int D, int* smem) {
  const bool on = D > 0 && D % 128 == 0 && D <= DA_MAX_D;
  smem[1] = on ? da_stages(D) : 0;
  smem[0] = on ? (int)da_smem_bytes(D, smem[1]) : 0;
  return 0;
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
