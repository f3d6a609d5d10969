// The port's streaming attention forward and dV pass (sdm_tpu_torch/csrc/
// streaming_attention.cu) one pass at a time, with the choices the entry
// points make left open, for tools/torch_streaming_tiles.py: the wgmma
// stats at 64 or 128 kept rows a block and the wgmma apply (apply_pass, or
// dv_pass with the roles swapped as sdm_streaming_dv swaps them) in loads
// of four or eight chunks, each at a ring depth (0: what the entry points
// take), from real or zero-filled boxes; and, for the A/B, the mma.sync
// kernels they replaced: stream_apply_mma (torch_mma_sync.cuh), which ran
// the forward's apply and then dV, and attn_stats_mma<streaming> (below).
// Built a second time with -DSW_PHASE_CLOCKS for the kernels' cycles by
// phase (tiles_phase_clocks).
#include "../sdm_tpu_torch/csrc/streaming_attention.cu"
#include "torch_mma_sync.cuh"

// Returned, launching nothing, where the shape does not take the kept
// rows, load size or ring depth asked for.
#define TILES_ERR_PLAN (-1)

// The maps' extent: the whole (B, S, D) view, or with `no_memory` a 256 x
// 64 slice of its first batch row only, so that every other box is
// zero-filled and the kernels run their rings and products without global
// reads.
static void tiles_extent(int no_memory, int* batch, int* S, int* D) {
  if (no_memory) {
    *batch = 1;
    *S = 256;
    *D = SW_BOX;
  }
}

// stream_stats_wgmma at `kept` rows a block (64 or 128; 0: sw_stats_kept's)
// with `stages` ring stages (0: the most that fit). strides: (sb, ss) of q
// and k.
SDM_EXPORT int tiles_stream_stats(const void* q, const void* k,
                                  const long long* strides, int batch, int S,
                                  int D, float scale, int axis_q, int stages,
                                  int kept, int no_memory, float* m, float* l,
                                  void* stream_ptr) {
  View views[2];
  read_views(strides, views, 2);
  if (kept == 0) kept = sw_stats_kept(D);
  if (kept != SW_ROWS && kept != 2 * SW_ROWS) return TILES_ERR_PLAN;
  if (stages == 0) stages = sw_stats_stages(D, kept);
  if (stages < 2 || sw_stats_smem_bytes(D, stages, kept) > MAX_SMEM)
    return TILES_ERR_PLAN;
  int mb = batch, ms = S, md = D;
  tiles_extent(no_memory, &mb, &ms, &md);
  const void* kept_p = axis_q ? k : q;
  const void* red_p = axis_q ? q : k;
  CUtensorMap tkept, tred;
  int rc = sw_map(&tkept, kept_p, views[axis_q ? 1 : 0], mb, ms, md, kept);
  if (rc == 0)
    rc = sw_map(&tred, red_p, views[axis_q ? 0 : 1], mb, ms, md, SW_RED);
  if (rc != 0) return rc;
  return run_stats_wgmma(tkept, tred, kept, batch, S, D, stages, scale, m, l,
                         static_cast<cudaStream_t>(stream_ptr));
}

// stream_apply_wgmma<..., Pass> on q, k, v and out (ptrs, views), out in
// fp32 (out_f32) or bf16, in loads of `ac` chunks (0: sw_apply_chunks's)
// with `stages` ring stages (0: the most that fit).
template <typename Pass>
static int tiles_apply(const void* const* ptrs, void* o, const View* views,
                       int batch, int S, int D, float scale, int axis_q,
                       int out_f32, int stages, int ac, int no_memory,
                       const float* m, const float* l, void* stream_ptr) {
  if (ac == 0) ac = sw_apply_chunks(D);
  if (stages == 0) stages = sw_apply_stages(D, ac);
  int split, cols;
  sw_split(D, &split, &cols);
  if (sw_apply_kernel<float, Pass>(axis_q, cols, ac) == nullptr ||
      stages < sw_apply_min_stages(ac) ||
      sw_apply_smem_bytes(D, stages, ac) > MAX_SMEM)
    return TILES_ERR_PLAN;
  int mb = batch, ms = S, md = D;
  tiles_extent(no_memory, &mb, &ms, &md);
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int rc = sw_map(&maps[i], ptrs[i], views[i], mb, ms, md, SW_ROWS,
                          ac);
    if (rc != 0) return rc;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // dV writes fp32 alone: no bf16-output dv_pass instantiation is built.
  if (out_f32 || std::is_same<Pass, dv_pass>::value)
    return run_apply_wgmma<Pass>(maps, axis_q, static_cast<float*>(o),
                                 views[3], batch, S, D, stages, ac, scale, m,
                                 l, stream);
  if constexpr (std::is_same<Pass, apply_pass>::value)
    return run_apply_wgmma<Pass>(maps, axis_q, static_cast<bf16*>(o),
                                 views[3], batch, S, D, stages, ac, scale, m,
                                 l, stream);
  return TILES_ERR_PLAN;
}

// The forward's apply pass. strides: (sb, ss) of q, k, v and out.
SDM_EXPORT int tiles_stream_apply(const void* q, const void* k, const void* v,
                                  void* o, const long long* strides,
                                  int batch, int S, int D, float scale,
                                  int axis_q, int out_f32, int stages, int ac,
                                  int no_memory, const float* m,
                                  const float* l, void* stream_ptr) {
  View views[4];
  read_views(strides, views, 4);
  const void* ptrs[3] = {q, k, v};
  return tiles_apply<apply_pass>(ptrs, o, views, batch, S, D, scale, axis_q,
                                 out_f32, stages, ac, no_memory, m, l,
                                 stream_ptr);
}

// The dV pass into fp32 dv, the roles as sdm_streaming_dv swaps them: the
// apply's (q, k, v, out) are (k, q, g, dv) on the other axis. strides:
// (sb, ss) of q, k, g and dv; m, l the forward's stats on `axis_q`.
static void tiles_dv_views(const long long* strides, View* views) {
  View in[4];
  read_views(strides, in, 4);
  views[0] = in[1];
  views[1] = in[0];
  views[2] = in[2];
  views[3] = in[3];
}

SDM_EXPORT int tiles_stream_dv(const void* q, const void* k, const void* g,
                               float* dv, const long long* strides, int batch,
                               int S, int D, float scale, int axis_q,
                               int stages, int ac, int no_memory,
                               const float* m, const float* l,
                               void* stream_ptr) {
  View views[4];
  tiles_dv_views(strides, views);
  const void* ptrs[3] = {k, q, g};
  return tiles_apply<dv_pass>(ptrs, dv, views, batch, S, D, scale, !axis_q,
                              1, stages, ac, no_memory, m, l, stream_ptr);
}

// ---------------------------------------------------------------------------
// attn_stats_mma<Caller, CHUNK>: the mma.sync stats kernel (bf16 in, fp32
// (m, l) out) that the streaming forward ran before stream_stats_wgmma
// took every shape it admitted; nothing in the port launches it, and its
// source lives on here only for the sweep's A/B.
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

// The mma.sync kernels the forward ran before: attn_stats_mma<streaming>
// and stream_apply_mma<bf16, ..., apply_pass>; and the one dV ran before,
// stream_apply_mma<float, ..., dv_pass> (-1 where they do not admit the
// shape).
SDM_EXPORT int tiles_stream_stats_mma(const void* q, const void* k,
                                      const long long* strides, int batch,
                                      int S, int D, float scale, int axis_q,
                                      float* m, float* l, void* stream_ptr) {
  View views[2];
  read_views(strides, views, 2);
  const void* ptrs[2] = {q, k};
  if (!stats_mma_ok(SDM_BF16, ptrs, views, S, D)) return -1;
  return (int)launch_stats_mma<streaming>(
      static_cast<const bf16*>(q), views[0], static_cast<const bf16*>(k),
      views[1], batch, 1, S, D, scale, axis_q, m, l,
      static_cast<cudaStream_t>(stream_ptr));
}

SDM_EXPORT int tiles_stream_apply_mma(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int batch,
                                      int S, int D, float scale, int axis_q,
                                      const float* m, const float* l,
                                      void* stream_ptr) {
  View views[4];
  read_views(strides, views, 4);
  const void* ptrs[4] = {q, k, v, o};
  if (!stream_mma_ok(SDM_BF16, ptrs, views, S, D)) return -1;
  return (int)launch_apply_mma<apply_pass>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), views, batch, 1, S,
      D, 1, D, scale, axis_q, m, l, static_cast<cudaStream_t>(stream_ptr));
}

SDM_EXPORT int tiles_stream_dv_mma(const void* q, const void* k,
                                   const void* g, float* dv,
                                   const long long* strides, int batch, int S,
                                   int D, float scale, int axis_q,
                                   const float* m, const float* l,
                                   void* stream_ptr) {
  View views[4];
  tiles_dv_views(strides, views);
  const void* ptrs[4] = {k, q, g, dv};
  if (!stream_mma_ok(SDM_BF16, ptrs, views, S, D)) return -1;
  return (int)launch_apply_mma<dv_pass>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(q),
      static_cast<const bf16*>(g), dv, views, batch, 1, S, D, 1, D, scale,
      !axis_q, m, l, static_cast<cudaStream_t>(stream_ptr));
}

#ifdef SW_PHASE_CLOCKS
// The phase clocks summed over blocks since the last reset (16 values:
// the stats' 8 phases, then the apply's), then reset to 0.
SDM_EXPORT int tiles_phase_clocks(unsigned long long* out) {
  static const unsigned long long zero[2][8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, sw_phase_clocks,
                                         sizeof(sw_phase_clocks));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(sw_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif
