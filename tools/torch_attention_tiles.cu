// The port's whole-S attention kernels (sdm_tpu_torch/csrc/attention.cu)
// one pass at a time, with the choices launch_wgmma makes left open, for
// tools/torch_attention_tiles.py: the stats pass at a ring depth, the apply
// at a column split and a ring depth (0: what attention.cu takes).
#include "../sdm_tpu_torch/csrc/attention.cu"

// The maps of q, k and v (64-row loads) and of the reduced rows of the
// stats (128-row loads), as launch_wgmma encodes them; with `no_memory`
// over the first 256 x 64 elements of one batch row and head only, so that
// every other load is zero-filled (no global reads): the kernels' rings
// and products alone.
static int tiles_maps(const void* q, const void* k, const void* v,
                      const long long* strides, int batch, int heads, int S,
                      int D, int axis_q, int no_memory, CUtensorMap* tq,
                      CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tred) {
  View views[4];
  read_views(strides, views, 4);
  if (no_memory) {
    batch = heads = 1;
    S = 256;
    D = 64;
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  int rc = wgmma_map(tq, qp, views[0], batch, heads, S, D, WROWS);
  if (rc == 0) rc = wgmma_map(tk, kp, views[1], batch, heads, S, D, WROWS);
  if (rc == 0)
    rc = wgmma_map(tv, static_cast<const bf16*>(v), views[2], batch, heads, S,
                   D, WROWS);
  if (rc == 0)
    rc = axis_q ? wgmma_map(tred, qp, views[0], batch, heads, S, D, WRED)
                : wgmma_map(tred, kp, views[1], batch, heads, S, D, WRED);
  return rc;
}

// attn_stats_wgmma with `stages` ring stages (0: attention.cu's),
// from zero-filled boxes with `no_memory`.
SDM_EXPORT int tiles_attention_stats(const void* q, const void* k,
                                     const long long* strides, int batch,
                                     int heads, int S, int D, float scale,
                                     int axis_q, int stages, int no_memory,
                                     float* m, float* l, void* stream_ptr) {
  CUtensorMap tq, tk, tv, tred;
  int rc = tiles_maps(q, k, q, strides, batch, heads, S, D, axis_q, no_memory,
                      &tq, &tk, &tv, &tred);
  if (rc != 0) return rc;
  if (stages == 0) stages = wgmma_stats_stages(D);
  const size_t smem = wgmma_stats_smem_bytes(D) +
                      (size_t)(stages - wgmma_stats_stages(D)) * 2 * kLoadBytes;
  if (stages < 2 || smem > MAX_SMEM) return -1;
  cudaFuncSetAttribute(attn_stats_wgmma,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  attn_stats_wgmma<<<dim3(S / WROWS, batch * heads), WTHREADS, smem,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      axis_q ? tk : tq, tred, heads, S, D, stages, scale, m, l);
  return (int)cudaGetLastError();
}

// attn_apply_wgmma at `split` column slices (0: wgmma_plan's) with `stages`
// ring stages (0: attention.cu's). The ring must hold a tile's V loads, and
// a block at most 512 columns.
SDM_EXPORT int tiles_attention_apply(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int batch,
                                     int heads, int S, int D, float scale,
                                     int axis_q, int split, int stages,
                                     int no_memory, const float* m,
                                     const float* l, void* stream_ptr) {
  CUtensorMap tq, tk, tv, tred;
  int rc = tiles_maps(q, k, v, strides, batch, heads, S, D, axis_q, no_memory,
                      &tq, &tk, &tv, &tred);
  if (rc != 0) return rc;
  const int boxes = D / WBOX;
  int cols = D;
  if (split == 0)
    wgmma_plan(batch * heads, S, D, &split, &cols);
  else
    cols = (boxes + split - 1) / split * WBOX;
  if (stages == 0) stages = wgmma_apply_stages(D);
  const size_t smem = wgmma_apply_smem_bytes(D) +
                      (size_t)(stages - wgmma_apply_stages(D)) * kLoadBytes;
  if (cols > WCOLS || (D + cols - 1) / cols != split ||
      stages < (cols / WBOX + WCHUNKS - 1) / WCHUNKS || smem > MAX_SMEM)
    return -1;
  View views[4];
  read_views(strides, views, 4);
  auto kernel = wgmma_apply_kernel(axis_q, cols);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / WROWS, batch * heads, split), WAPPLY_THREADS, smem,
           static_cast<cudaStream_t>(stream_ptr)>>>(
      tq, tk, tv, static_cast<bf16*>(o), views[3], heads, S, D, cols, stages,
      scale, m, l, OutProj{});
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ wgmma rates
//
// What a warpgroup's wgmma issue pattern costs with no memory traffic:
// `rounds` rounds of CHAINS independent accumulators x four 16-deep steps
// of m64nNk16 from shared memory (B K-major, or MN-major through the
// transpose bit), issued chain by chain or interleaved step by step, one
// commit a round and at most two rounds in flight, as the kernels above
// issue them; one or two consumer warpgroups a block, one block an SM.

template <int N, int CHAINS, bool INTERLEAVE, bool MN>
__global__ void __launch_bounds__(256, 1)
wgmma_rate(int rounds, float* sink) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = align1024(smem_raw);
  const uint64_t da = wgmma_desc(tiles);
  const uint64_t db = MN ? wgmma_desc_mn(tiles + kChunkBytes)
                         : wgmma_desc(tiles + kChunkBytes);
  float acc[CHAINS][N / 2];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.f;
  auto step = [&](int c, int kk) {
    if constexpr (MN)
      wgmma_m64n64k16_mn(acc[c], da + 2 * kk, db + 128 * kk);
    else if constexpr (N == 32)
      wgmma_m64n32k16(acc[c], da + 2 * kk, db + 2 * kk);
    else
      wgmma_bf16<N>(acc[c], da + 2 * kk, db + 2 * kk);
  };
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) wgmma_fence_operands(acc[c]);
    wgmma_fence();
    if (INTERLEAVE) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) step(c, kk);
    } else {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) step(c, kk);
    }
    wgmma_commit();
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) wgmma_fence_operands(acc[c]);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s += acc[c][i];
  if (s == 12345.f) sink[threadIdx.x] = s;   // keeps the products live
}

// X(id, N, chains, interleaved, MN-major B)
#define RATE_VARIANTS(X)        \
  X(0, 32, 1, true, false)      \
  X(1, 32, 4, true, false)      \
  X(2, 64, 1, true, false)      \
  X(3, 64, 4, true, false)      \
  X(4, 128, 1, true, false)     \
  X(5, 256, 1, true, false)     \
  X(6, 64, 1, true, true)       \
  X(7, 64, 4, false, true)

#define RATE_CASE(id, N, CH, IL, MN)                                        \
  case id:                                                                  \
    cudaFuncSetAttribute(wgmma_rate<N, CH, IL, MN>,                         \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                         1024 + 5 * kChunkBytes);                           \
    wgmma_rate<N, CH, IL, MN><<<blocks, 128 * wgs, 1024 + 5 * kChunkBytes,  \
                                stream>>>(rounds, sink);                    \
    *flop_per_block = 2.0 * 64 * N * 16 * 4 * CH * (double)rounds * wgs;    \
    return (int)cudaGetLastError();

SDM_EXPORT int tiles_wgmma_rate(int variant, int wgs, int rounds, int blocks,
                                float* sink, double* flop_per_block,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (variant) { RATE_VARIANTS(RATE_CASE) }
  return -1;
}

#define RATE_NAME(id, N, CH, IL, MN)                                        \
  case id:                                                                  \
    return "m64n" #N "k16, " #CH " chains, interleaved " #IL                \
           ", B MN-major " #MN;

SDM_EXPORT const char* tiles_wgmma_rate_name(int variant) {
  switch (variant) { RATE_VARIANTS(RATE_NAME) }
  return nullptr;
}

// -------------------------------------------------------------- TMA rates
//
// How fast the ring delivers loads: one producer lane streams `loads`
// loads of 64 rows x CH chunks of 64 bf16 columns from a (16, S, 1, D)
// view (row stride `ld`) through a ring of `stages`, with the rank-5 map
// attention.cu encodes (sdm_tma_map_chunks). Two consumer warpgroups wait
// for each load and release it, with (MMA) or without four m64n64k16 a
// chunk on it each, one block an SM.

template <int CH, bool MMA>
__global__ void __launch_bounds__(288, 1)
tma_rate(const __grid_constant__ CUtensorMap map, int S, int D, int loads,
         int stages, float* sink) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  constexpr int BYTES = CH * kChunkBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * BYTES);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nd = D / (64 * CH), ns = S / 64;
  if (warp == 8) {
    if (lane == 0) {
      for (int it = 0; it < loads; ++it) {
        const int st = it % stages;
        if (it >= stages) mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], BYTES);
        const int j = it + blockIdx.x * 7;
        tma_load_chunks(ring + st * BYTES, &map, &full[st],
                        ((j / nd) % ns) * 64, (j % nd) * CH, 0,
                        (j / (nd * ns)) % 16);
      }
    }
    return;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int it = 0; it < loads; ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    if (MMA) {
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint64_t da = wgmma_desc(ring + st * BYTES + c * kChunkBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16(acc, da + 2 * kk, da + 2 * kk);
      }
      wgmma_commit();
      wgmma_fence_operands(acc);
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    } else if (lane == 0) {
      mbar_arrive(&empty[st]);
    }
  }
  if (MMA) {
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(loads - 1) % stages]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += acc[i];
  if (s == 12345.f) sink[threadIdx.x] = s;
}

// X(id, chunks a load, with wgmma)
#define TMA_VARIANTS(X) \
  X(0, 1, false)        \
  X(1, 2, false)        \
  X(2, 4, false)        \
  X(3, 1, true)         \
  X(4, 2, true)         \
  X(5, 4, true)

#define TMA_CASE(id, CH, MMA)                                               \
  case id: {                                                                \
    CUtensorMap map;                                                        \
    const int rc = sdm_tma_map_chunks(&map, x, 16, S, 1, D,                 \
                                      (long long)S * ld, ld, ld, 64, CH);   \
    if (rc != 0) return rc;                                                 \
    const int smem = 1024 + stages * CH * kChunkBytes + 2 * stages * 8;    \
    if (smem > MAX_SMEM) return -1;                                         \
    cudaFuncSetAttribute(tma_rate<CH, MMA>,                                 \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\
    tma_rate<CH, MMA><<<blocks, 288, smem, stream>>>(map, S, D, loads,      \
                                                     stages, sink);         \
    return (int)cudaGetLastError();                                         \
  }

SDM_EXPORT int tiles_tma_rate(int variant, const void* x, int S, int D,
                              long long ld, int loads, int stages, int blocks,
                              float* sink, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (variant) { TMA_VARIANTS(TMA_CASE) }
  return -1;
}

#define TMA_NAME(id, CH, MMA) \
  case id:                    \
    return "64-row loads of " #CH " chunks, wgmma " #MMA;

SDM_EXPORT const char* tiles_tma_rate_name(int variant) {
  switch (variant) { TMA_VARIANTS(TMA_NAME) }
  return nullptr;
}
