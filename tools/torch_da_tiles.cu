// The port's streaming dK and dQ kernel, stream_da_wgmma
// (sdm_tpu_torch/csrc/streaming_attention.cu), with its ring depth left
// open, and the mma.sync kernel it replaced, stream_da_mma (kept here, as
// it stood in the library, for the A/B), for tools/torch_da_tiles.py. The
// script builds this file once a setting of the library's compile-time
// tiling: the defaults, -DDA_LOAD_CHUNKS=2 (16 KB loads), -DDA_TILE=32
// (32-row tiles, m64n16 score products, the n16 tiling of stream_da_mma
// kept on wgmma) and -DSW_PHASE_CLOCKS (cycles by phase,
// tiles_da_phase_clocks).
#include "../sdm_tpu_torch/csrc/streaming_attention.cu"
#include "torch_mma_sync.cuh"

// ---------------------------------------------------------------------------
// stream_da_mma<STAT_COL, Pass, BM, BN, KSPLIT>: BM own rows of A and A2
// resident (cp.async), a 2-stage cp.async ring of BN-row tiles of B and B2,
// score tiles on mma.sync m16n8k16 over all of D or two D halves (KSPLIT),
// dA through a shared tile, dA B by ldmatrix.trans; launched at BM = 64,
// BN = 16, KSPLIT = 2 (5.41-5.76 ms a pass at (16, 4096, 512) bf16 on an
// H100 SXM, 700 W).
// ---------------------------------------------------------------------------

#define MMA_DA_THREADS 256
#define MMA_DA_MAXD 512           // widest D of stream_da_mma
// The tiling the dK and dQ passes launched: own rows per block, streamed
// rows per ring stage, D slices per score tile.
#define MMA_DA_BM 64
#define MMA_DA_BN 16
#define MMA_DA_KSPLIT 2

template <int BM, int BN, int KSPLIT>
static size_t da_mma_smem_bytes(int D) {
  return 2 * (size_t)BM * (D + 8) * sizeof(bf16)        // A and A2 tiles
         + 2 * 2 * (size_t)BN * (D + 8) * sizeof(bf16)  // ring: B and B2
         + (size_t)BM * (BN + 8) * sizeof(bf16)         // rounded dA tile
         + 2 * 3 * BN * sizeof(float)                   // ring: m, l, corr
         + (KSPLIT - 1) * 8 * 8 * 32 * sizeof(float);   // partial scores
}

template <bool STAT_COL, typename Pass, int BM, int BN, int KSPLIT>
__global__ void __launch_bounds__(MMA_DA_THREADS, 1)
stream_da_mma(const bf16* __restrict__ a, View av, const bf16* __restrict__ a2,
              View a2v, const bf16* __restrict__ bm, View bv,
              const bf16* __restrict__ b2, View b2v, float* __restrict__ o,
              View ov, int S, int D, float scale,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              const float* __restrict__ c_in) {
  constexpr int WR = BM / 16;              // row groups, both phases
  constexpr int TILES = 8 / KSPLIT;        // score tiles of 16 rows x WN
  constexpr int WNC = TILES / WR;          // their column groups
  constexpr int WN = BN / WNC;             // streamed rows per score tile
  constexpr int NB = WN / 8;               // its 8-row mma blocks
  constexpr int OC = 8 / WR;               // dA B output column groups
  constexpr int NT = MMA_DA_MAXD / OC / 8;     // accumulator blocks per warp
  constexpr int DLD = BN + 8;              // bf16 pitch of the dA tile
  static_assert(WR * WNC * KSPLIT == 8 && (WN == 8 || WN == 16) &&
                (KSPLIT == 1 || KSPLIT == 2), "stream_da_mma tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);          // [BM][ld]
  bf16* A2s = As + BM * ld;                              // [BM][ld]
  bf16* Ring = A2s + BM * ld;                            // [2][B, B2][BN][ld]
  bf16* Ds = Ring + 4 * BN * ld;                         // [BM][DLD]
  float* St = reinterpret_cast<float*>(Ds + BM * DLD);   // [2][m, l, c][BN]
  float* X = St + 2 * 3 * BN;                            // [8][4 NB][32]

  const int b = blockIdx.y;
  const bf16* ap = slice_ptr(a, av, 1, b);
  const bf16* a2p = slice_ptr(a2, a2v, 1, b);
  const bf16* bp = slice_ptr(bm, bv, 1, b);
  const bf16* b2p = slice_ptr(b2, b2v, 1, b);
  float* op = slice_ptr(o, ov, 1, b);
  const float* mb = m_in + (long long)b * S;
  const float* lb = l_in + (long long)b * S;
  const float* cb = c_in + (long long)b * S;
  const int i0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp % WR;                 // own rows 16 wr .. +16
  const int wc = (warp / WR) % WNC;         // score columns WN wc .. +WN
  const int kh = warp / TILES;              // score D slice
  const int kspan = D / KSPLIT;
  const int wcols = D / OC;                 // dA B output columns per warp
  const int cbase = (warp / WR) * wcols;

  // The own rows join the first cp.async group, with streamed tile 0.
  cp_async_rows(As, ld, ap + (long long)i0 * av.ss, av.ss, BM, D / 8, tid,
                MMA_DA_THREADS);
  cp_async_rows(A2s, ld, a2p + (long long)i0 * a2v.ss, a2v.ss, BM, D / 8,
                tid, MMA_DA_THREADS);
  // Streamed tile at j0 into ring stage `st`: B, B2 and (STAT_COL) the
  // rows' m, l and corr.
  auto load_tile = [&](int j0, int st) {
    bf16* Bs = Ring + st * 2 * BN * ld;
    cp_async_rows(Bs, ld, bp + (long long)j0 * bv.ss, bv.ss, BN, D / 8, tid,
                  MMA_DA_THREADS);
    cp_async_rows(Bs + BN * ld, ld, b2p + (long long)j0 * b2v.ss, b2v.ss, BN,
                  D / 8, tid, MMA_DA_THREADS);
    if (STAT_COL && tid < 3 * BN) {
      const float* src = tid < BN ? mb : tid < 2 * BN ? lb : cb;
      cp_async4(smem_u32(St + st * 3 * BN + tid), src + j0 + tid % BN);
    }
  };

  // Own-row stats: those of this lane's two rows, for the whole loop.
  float mrow[2] = {0.f, 0.f}, lrow[2] = {1.f, 1.f}, crow[2] = {0.f, 0.f};
  if (!STAT_COL) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i0 + wr * 16 + g + 8 * hh;
      mrow[hh] = mb[row];
      lrow[hh] = lb[row];
      crow[hh] = cb[row];
    }
  }

  // ldmatrix lane addresses (bytes, shared window). A fragments (A, A2, dA):
  // lanes 0-15 rows 0-15 at column 0, lanes 16-31 rows 0-15 at column 8. B
  // of the scores, WN = 16: lanes 0-7 rows 0-7 / d 0, 8-15 rows 0-7 / d 8,
  // 16-23 rows 8-15 / d 0, 24-31 rows 8-15 / d 8, so registers 0-1 are row
  // block 0's fragment and 2-3 row block 1's; WN = 8: lanes 8i .. 8i+7 rows
  // 0-7 at d 8i, so registers 0-1 are one 16-deep step's fragment and 2-3
  // the next one's. B of dA B (transposed): lanes 0-15 rows 0-15 at column
  // 0, 16-31 at column 8, so registers 0-1 are column block 0, 2-3 block 1.
  const unsigned aa = smem_u32(As + (wr * 16 + (lane & 15)) * ld +
                               (lane >> 4) * 8 + kh * kspan);
  const unsigned a2a = aa + BM * ld * 2;
  const unsigned da = smem_u32(Ds + (wr * 16 + (lane & 15)) * DLD +
                               (lane >> 4) * 8);
  const int kb_off =
      (WN == 16 ? (wc * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                      ((lane >> 3) & 1) * 8
                : (wc * 8 + (lane & 7)) * ld + (lane >> 3) * 8) +
      kh * kspan;
  const int vb_off = (lane & 15) * ld + cbase + (lane >> 4) * 8;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = S / BN;
  load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();
    // Tile t (and A, A2) visible to every warp; every warp is done with
    // tile t - 1, so its stage, the dA tile and the exchange may be
    // overwritten.
    __syncthreads();
    if (t + 1 < ntiles) load_tile((t + 1) * BN, st ^ 1);
    cp_async_commit();

    const bf16* Bs = Ring + st * 2 * BN * ld;
    const unsigned kb = smem_u32(Bs + kb_off);
    const unsigned kb2 = kb + BN * ld * 2;

    float s[2][NB][4], dp[2][NB][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[p][n][e] = dp[p][n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kspan; kk += 32) {
      if constexpr (WN == 16) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          unsigned x[4], y[4];
          ldsm_x4(x, aa + (kk + 16 * p) * 2);
          ldsm_x4(y, kb + (kk + 16 * p) * 2);
          mma_bf16(s[p][0], x, y[0], y[1]);
          mma_bf16(s[p][1], x, y[2], y[3]);
          ldsm_x4(x, a2a + (kk + 16 * p) * 2);
          ldsm_x4(y, kb2 + (kk + 16 * p) * 2);
          mma_bf16(dp[p][0], x, y[0], y[1]);
          mma_bf16(dp[p][1], x, y[2], y[3]);
        }
      } else {
        unsigned y[4], y2[4];
        ldsm_x4(y, kb + kk * 2);
        ldsm_x4(y2, kb2 + kk * 2);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          unsigned x[4];
          ldsm_x4(x, aa + (kk + 16 * p) * 2);
          mma_bf16(s[p][0], x, y[2 * p], y[2 * p + 1]);
          ldsm_x4(x, a2a + (kk + 16 * p) * 2);
          mma_bf16(dp[p][0], x, y2[2 * p], y2[2 * p + 1]);
        }
      }
    }
    // This lane's scores: rows 16 wr + g + 8 hh, streamed columns
    // WN wc + 8 n + 2 tg + e, at [n][2 hh + e].
    float sv[NB][4], dv[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[n][e] = s[0][n][e] + s[1][n][e];
        dv[n][e] = dp[0][n][e] + dp[1][n][e];
      }
    if constexpr (KSPLIT == 2) {
      // Warp kh finishes rows hh = kh and passes its partial sums of rows
      // hh = 1 - kh to the warp of the other D half (warp ^ TILES).
      float* xw = X + warp * 4 * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (hh != kh) {
              xw[(4 * n + 2 * e) * 32] = sv[n][2 * hh + e];
              xw[(4 * n + 2 * e + 1) * 32] = dv[n][2 * hh + e];
            }
      __syncthreads();
      const float* xr = X + (warp ^ TILES) * 4 * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (hh == kh) {
              sv[n][2 * hh + e] += xr[(4 * n + 2 * e) * 32];
              dv[n][2 * hh + e] += xr[(4 * n + 2 * e + 1) * 32];
            }
    }
    // dA = p (dp - corr), rounded to bf16 into the dA tile.
    const float* stt = St + st * 3 * BN;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = wc * WN + n * 8 + 2 * tg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (KSPLIT == 2 && hh != kh) continue;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mm = STAT_COL ? stt[col + e] : mrow[hh];
          const float ll = STAT_COL ? stt[BN + col + e] : lrow[hh];
          const float cc = STAT_COL ? stt[2 * BN + col + e] : crow[hh];
          const float p = expf(sv[n][2 * hh + e] * scale - mm) / ll;
          x[e] = p * (dv[n][2 * hh + e] - cc);
        }
        store_pair(Ds + (wr * 16 + g + 8 * hh) * DLD + col, x[0], x[1]);
      }
    }
    __syncthreads();   // the dA tile is complete
    pv_tile<BN>(acc, da, smem_u32(Bs + vb_off), ld, wcols);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= scale;
  store_acc(op, ov.ss, acc, i0 + wr * 16 + g, cbase, wcols, tg);
}

// Launch stream_da_mma<..., BM, BN, KSPLIT>: grid (S/BM, batch). views: A,
// A2, B, B2, out.
template <typename Pass, int BM, int BN, int KSPLIT>
static cudaError_t launch_da_mma(const bf16* a, const bf16* a2,
                                 const bf16* bm, const bf16* b2, float* o,
                                 const View* views, int batch, int S, int D,
                                 float scale, bool stat_col, const float* m,
                                 const float* l, const float* c,
                                 cudaStream_t stream) {
  const size_t smem = da_mma_smem_bytes<BM, BN, KSPLIT>(D);
  auto kernel = stat_col ? &stream_da_mma<true, Pass, BM, BN, KSPLIT>
                         : &stream_da_mma<false, Pass, BM, BN, KSPLIT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<dim3(S / BM, batch), MMA_DA_THREADS, smem, stream>>>(
      a, views[0], a2, views[1], bm, views[2], b2, views[3], o, views[4], S,
      D, scale, m, l, c);
  return cudaGetLastError();
}

// The new kernel on the roles as sdm_streaming_dq / _dk assign them
// (pass_q: dq_pass, else dk_pass), with `stages` ring stages (0: the most
// that fit). strides: (sb, ss) of A, A2, B, B2 and out. -1, launching
// nothing, where the shape or the stages are refused.
SDM_EXPORT int tiles_da_wgmma(int pass_q, const void* a, const void* a2,
                              const void* b, const void* b2, float* o,
                              const long long* strides, int batch, int S,
                              int D, float scale, int stat_col, int stages,
                              const float* m, const float* l, const float* c,
                              void* stream_ptr) {
  View views[5];
  read_views(strides, views, 5);
  const void* ptrs[5] = {a, a2, b, b2, o};
  if (!da_wgmma_ok(SDM_BF16, ptrs, views, S, D)) return -1;
  if (stages == 0) stages = da_stages(D);
  if (stages < 2 || da_smem_bytes(D, stages) > MAX_SMEM)
    return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (pass_q)
    return launch_da_wgmma<dq_pass>(ptrs, views, o, batch, S, D, stages,
                                    scale, stat_col, m, l, c, stream);
  return launch_da_wgmma<dk_pass>(ptrs, views, o, batch, S, D, stages, scale,
                                  stat_col, m, l, c, stream);
}

// The old kernel at its launched tiling (64 own rows, 16-row tiles, two D
// halves), same arguments but the stages.
SDM_EXPORT int tiles_da_mma(int pass_q, const void* a, const void* a2,
                            const void* b, const void* b2, float* o,
                            const long long* strides, int batch, int S,
                            int D, float scale, int stat_col, const float* m,
                            const float* l, const float* c,
                            void* stream_ptr) {
  View views[5];
  read_views(strides, views, 5);
  if (S % MMA_DA_BM || D % 128 || D > MMA_DA_MAXD ||
      da_mma_smem_bytes<MMA_DA_BM, MMA_DA_BN, MMA_DA_KSPLIT>(D) > MAX_SMEM)
    return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16 *pa = static_cast<const bf16*>(a),
             *pa2 = static_cast<const bf16*>(a2),
             *pb = static_cast<const bf16*>(b),
             *pb2 = static_cast<const bf16*>(b2);
  if (pass_q)
    return (int)launch_da_mma<dq_pass, MMA_DA_BM, MMA_DA_BN, MMA_DA_KSPLIT>(
        pa, pa2, pb, pb2, o, views, batch, S, D, scale, stat_col, m, l, c,
        stream);
  return (int)launch_da_mma<dk_pass, MMA_DA_BM, MMA_DA_BN, MMA_DA_KSPLIT>(
      pa, pa2, pb, pb2, o, views, batch, S, D, scale, stat_col, m, l, c,
      stream);
}

// setting: DA_TILE, the chunks a load at D, and at D the ring stages and
// the dynamic shared memory.
SDM_EXPORT int tiles_da_setting(int D, int* setting) {
  setting[0] = DA_TILE;
  setting[1] = da_load_chunks(D);
  setting[2] = da_stages(D);
  setting[3] = (int)da_smem_bytes(D, setting[2]);
  return 0;
}

#ifdef SW_PHASE_CLOCKS
// stream_da_wgmma's cycles by phase since the last call (thread 0 of every
// block, summed), then zeroed.
SDM_EXPORT int tiles_da_phase_clocks(unsigned long long* out) {
  static const unsigned long long zero[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, da_phase_clocks,
                                         sizeof(da_phase_clocks));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(da_phase_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif
