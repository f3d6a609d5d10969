// Tiled GEMM with a bias (+ residual) epilogue: y = T(x W^T + b) [+ res].
//
// The two projections of the attention block kernel, which the TPU kernel
// sdm_tpu/kernels/attention_block.py::fused_attention_block computes in its
// own body (_block_kernel: qkv = tok W_qkv + b at :66, out = r W_out + b_out
// + tok at :76). On the H100 the block's weights (W_qkv alone is 512 x 1536)
// do not fit one SM next to the token tile, so the block runs as three
// hand-written kernels: this GEMM for the qkv projection, the attention
// kernel (attention.cu), and this GEMM again with the residual epilogue for
// the output projection.
//
// Rounding follows the JAX composite (_xla_block, attention_block.py:121-131):
// fp32 accumulation, fp32 bias added, one rounding to T; the residual is
// added to that rounded value in fp32 and rounded again (JAX adds the tokens
// in the compute dtype).
//
// x is (M, K) with row stride ldx and a unit column stride; w is the
// nn.Linear weight (N, K), contiguous. Two paths:
//   - bf16 with K % 32 == 0, ldx % 8 == 0 and 16-byte aligned x, w and
//     residual (linear_mma_ok; every U-Net projection): linear_mma, tensor
//     cores through mma.sync, below;
//   - otherwise linear_nt: fp32 FMA on the CUDA cores, 64 x 64 tiles with a
//     4 x 4 register tile per thread.
#include "mma_tiles.cuh"

#define TM 64
#define TN 64
#define TK 32

template <typename T>
__global__ void __launch_bounds__(256)
linear_nt(const T* __restrict__ x, long long ldx, const T* __restrict__ w,
          const void* __restrict__ bias, int bias_dt,
          const T* __restrict__ res, T* __restrict__ y, int M, int N, int K) {
  __shared__ float As[TK * (TM + 1)];
  __shared__ float Bs[TK * (TN + 1)];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += blockDim.x) {
      const int r = e / TK, kk = e - r * TK;
      float a = 0.f, bw = 0.f;
      if (k0 + kk < K) {
        if (m0 + r < M) a = sdm_to_float(x[(long long)(m0 + r) * ldx + k0 + kk]);
        if (n0 + r < N) bw = sdm_to_float(w[(long long)(n0 + r) * K + k0 + kk]);
      }
      As[kk * (TM + 1) + r] = a;
      Bs[kk * (TN + 1) + r] = bw;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * (TM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * (TN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float val = sdm_round<T>(acc[i][j] + sdm_load(bias, n, bias_dt));
      if (res != nullptr) val += sdm_to_float(res[(long long)m * N + n]);
      y[(long long)m * N + n] = sdm_from_float<T>(val);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: linear_mma, bf16 in and out, fp32 accumulation.
//
// Bound: operations, 2 M N K against (M K + N K + M N) * 2 bytes: at the
// flagship's qkv projection (M = 16384, N = 1536, K = 512) about 390
// operations per byte, above the H100's ~295 for bf16.
//
// Block: BM x BN outputs, WM x WN warps. Both operands are K-contiguous (x
// rows, W rows), so plain ldmatrix.x4 gives the A fragments (x) and the B
// fragments (W stored [n][k], B's column-major layout), as for Q and K in
// attn_stats_mma. Per 16-deep step a warp loads its A and B fragments with
// ldmatrix.x4 (one per 16 rows or 16 columns) and issues two m16n8k16
// mma.sync per (A, B) pair; the next step's fragments are loaded into a
// second register set while this step's mma.sync run.
//
// Shared memory: a ring of STAGES stages, each the block's x rows and W
// rows for BK columns of K, [rows][BK + 8] bf16 (the 8-element pad puts the
// eight 16-byte rows of every ldmatrix on distinct banks). Stage i +
// STAGES - 1 is loaded by cp.async.cg while stage i is multiplied; one
// cp.async.wait_group and one __syncthreads per stage. Rows past M or N are
// zero-filled by the copy (src-size 0) and their outputs masked at the
// store, so ragged M and N need no other path; K is a multiple of BK.
//
// Two instantiations (linear_mma_tile): 128 x 128 blocks of 8 warps (2 x 4)
// of 64 x 32, and, where that grid would leave half the 132 SMs idle, 64 x
// 64 blocks of 4 warps of 32 x 32 (M = N = 1024: 64 tiles of 128 x 128, 256
// of 64 x 64). Both with BK = 32 and 4 stages: 81,920 bytes of ring at the
// 128 tile, two blocks an SM. Chosen from a sweep on an H100 SXM (700 W,
// tools/torch_linear_tiles.py) over 128 x 256, 256 x 128, 64 x 128 blocks,
// 4 to 16 warps, BK 32 or 64 and 3 to 6 stages: within 10 % of each other
// at M >= 4096, none within 2x of cuBLAS. The same kernels with every
// global load zero-filled (no memory traffic at all) ran at 320-385
// TFLOP/s: the mma.sync + ldmatrix pipeline itself stays far below the
// 989 TFLOP/s bf16 peak, which only wgmma reaches.
//
// The epilogue works on the accumulator fragments (lane L holds rows L/4 and
// L/4 + 8, columns 2 (L%4) and +1 of each 16 x 8 tile): bias added in fp32,
// rounded to bf16, the residual pair added in fp32, and the pair rounded
// again and stored as one bf16x2 (single elements where N is odd).
//
// What this design does about the WMMA kernel it replaced: that kernel
// copied each 32-deep K slice with synchronous 16-byte loads between two
// barriers (nothing in flight during the products; here three stages are),
// and staged every 16 x 16 output tile through a 1 KB fp32 shared tile per
// warp, one element per lane at a time, with a bias load per element.
// ---------------------------------------------------------------------------

#define LBK 32                // K depth of one ring stage
#define LSTAGES 4             // ring depth
#define LTILE 128             // block tile where the grid fills the card
#define LTILE_SMALL 64        // block tile where it would not
#define LSMS 132              // SMs of the H100

// linear_mma's admission. res may be null.
static bool linear_mma_ok(const void* x, long long ldx, const void* w,
                          const void* res, int K, int dt) {
  return dt == SDM_BF16 && K % LBK == 0 && ldx % 8 == 0 && aligned16(x) &&
         aligned16(w) && (res == nullptr || aligned16(res));
}

// The block tile: LTILE where its grid covers at least half the SMs, else
// LTILE_SMALL.
static int linear_mma_tile(int M, int N) {
  const long long tiles =
      (long long)((M + LTILE - 1) / LTILE) * ((N + LTILE - 1) / LTILE);
  return 2 * tiles >= LSMS ? LTILE : LTILE_SMALL;
}

template <int BM, int BN, int WM, int WN, int BK, int STAGES, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
linear_mma(const bf16* __restrict__ x, long long ldx,
           const bf16* __restrict__ w, const void* __restrict__ bias,
           int bias_dt, const bf16* __restrict__ res, bf16* __restrict__ y,
           int M, int N, int K) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;   // warp tile
  constexpr int MI = WTM / 16;        // 16-row A fragments per warp
  constexpr int NB = WTN / 16;        // 16-column B ldmatrix.x4 per warp
  constexpr int LD = BK + 8;          // bf16 pitch of a staged row
  constexpr int STAGE = (BM + BN) * LD;   // bf16 per ring stage
  constexpr int CPR = BK / 8;         // 16-byte chunks a staged row
  static_assert(BM * CPR % THREADS == 0 && BN * CPR % THREADS == 0,
                "every thread copies whole rows' chunks");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ksteps = K / BK;

  // Ring stage `st` <- K columns [ks * BK, +BK) of the block's x rows and
  // W rows; rows past M or N zero-filled.
  auto load_chunk = [&](bf16* dst, const bf16* src, long long ss, int r0,
                        int rows, int c, int k0) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool valid = r0 + r < rows;
    cp_async16_zfill(smem_u32(dst + r * LD + cc),
                     src + (long long)(valid ? r0 + r : 0) * ss + k0 + cc,
                     valid);
  };
  auto load_stage = [&](int st, int ks) {
    bf16* xs = ring + st * STAGE;
#pragma unroll
    for (int j = 0; j < BM * CPR / THREADS; ++j)
      load_chunk(xs, x, ldx, m0, M, tid + j * THREADS, ks * BK);
#pragma unroll
    for (int j = 0; j < BN * CPR / THREADS; ++j)
      load_chunk(xs + BM * LD, w, K, n0, N, tid + j * THREADS, ks * BK);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane offsets (elements within a stage). A (x rows): lanes 0-15
  // rows 0-15 at k 0, lanes 16-31 rows 0-15 at k 8. B (W rows): lanes 0-7
  // rows 0-7 / k 0, 8-15 rows 0-7 / k 8, 16-23 rows 8-15 / k 0, 24-31 rows
  // 8-15 / k 8, so registers 0-1 are n-block 0's fragment and 2-3 n-block 1's.
  const int a_off = (wm * WTM + (lane & 15)) * LD + (lane >> 4) * 8;
  const int b_off = BM * LD +
                    (wn * WTN + (lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;

  // Fragments of one 16-deep step, double-buffered: step s + 1's are loaded
  // from shared memory while step s's mma.sync run.
  constexpr int KK = BK / 16;        // 16-deep steps a stage
  static_assert(KK % 2 == 0, "a stage's steps alternate the two buffers");
  unsigned a[2][MI][4], b[2][NB][4];
  auto load_frags = [&](int buf, int st, int kk) {
    const unsigned pa = smem_u32(ring + st * STAGE + a_off) + kk * 32;
    const unsigned pb = smem_u32(ring + st * STAGE + b_off) + kk * 32;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) ldsm_x4(a[buf][mi], pa + mi * 16 * LD * 2);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) ldsm_x4(b[buf][nb], pb + nb * 16 * LD * 2);
  };

  float acc[MI][2 * NB][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * NB; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  cp_async_wait<STAGES - 2>();
  __syncthreads();   // stage 0 visible to every warp
  if (ksteps > 0) load_frags(0, 0, 0);
  for (int i = 0; i < ksteps; ++i) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      if (kk == 0) {
        // Stage i - 1's slot is free: every warp loaded its last fragments
        // before the barrier that made stage i visible.
        if (i + STAGES - 1 < ksteps)
          load_stage((i + STAGES - 1) % STAGES, i + STAGES - 1);
        cp_async_commit();
      }
      if (kk < KK - 1) {
        load_frags((kk + 1) & 1, i % STAGES, kk + 1);
      } else if (i + 1 < ksteps) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // stage i + 1 visible; stage i's reads done
        load_frags(0, (i + 1) % STAGES, 0);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mma_bf16(acc[mi][2 * nb], a[kk & 1][mi], b[kk & 1][nb][0],
                   b[kk & 1][nb][1]);
          mma_bf16(acc[mi][2 * nb + 1], a[kk & 1][mi], b[kk & 1][nb][2],
                   b[kk & 1][nb][3]);
        }
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the fragments.
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int nj = 0; nj < 2 * NB; ++nj) {
    const int col = n0 + wn * WTN + nj * 8 + 2 * tg;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    const float b0 = sdm_load(bias, col, bias_dt);
    const float b1 = two ? sdm_load(bias, col + 1, bias_dt) : 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * WTM + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
        const long long o = (long long)row * N + col;
        float v0 = sdm_round<bf16>(acc[mi][nj][2 * hh] + b0);
        float v1 = sdm_round<bf16>(acc[mi][nj][2 * hh + 1] + b1);
        if (res != nullptr) {
          if (pairs) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + o));
            v0 += r.x;
            v1 += r.y;
          } else {
            v0 += __bfloat162float(res[o]);
            if (two) v1 += __bfloat162float(res[o + 1]);
          }
        }
        if (pairs) {
          store_pair(y + o, v0, v1);
        } else {
          y[o] = __float2bfloat16_rn(v0);
          if (two) y[o + 1] = __float2bfloat16_rn(v1);
        }
      }
  }
}

template <int BM, int BN, int WM, int WN, int BK, int STAGES, int MINB>
static cudaError_t launch_linear_mma(const bf16* x, long long ldx,
                                     const bf16* w, const void* bias,
                                     int bias_dt, const bf16* res, bf16* y,
                                     int M, int N, int K,
                                     cudaStream_t stream) {
  auto kernel = &linear_mma<BM, BN, WM, WN, BK, STAGES, MINB>;
  const size_t smem = (size_t)STAGES * (BM + BN) * (BK + 8) * sizeof(bf16);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(x, ldx, w, bias, bias_dt, res,
                                               y, M, N, K);
  return cudaGetLastError();
}

// Whether sdm_linear_forward takes the tensor-core path for these operands
// (res may be null).
SDM_EXPORT int sdm_linear_takes_mma(const void* x, long long ldx,
                                    const void* w, const void* res, int K,
                                    int dt) {
  return linear_mma_ok(x, ldx, w, res, K, dt);
}

// linear_mma's block tile (LTILE or LTILE_SMALL) for an M x N output.
SDM_EXPORT int sdm_linear_mma_tile(int M, int N) {
  return linear_mma_tile(M, N);
}
// res may be null. Returns cudaGetLastError() after the launch.
SDM_EXPORT int sdm_linear_forward(const void* x, long long ldx, const void* w,
                                  const void* bias, int bias_dt,
                                  const void* res, void* y, int M, int N,
                                  int K, int dt, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M == 0 || N == 0) return 0;
  if (linear_mma_ok(x, ldx, w, res, K, dt)) {
    auto launch =
        linear_mma_tile(M, N) == LTILE
            ? &launch_linear_mma<LTILE, LTILE, 2, 4, LBK, LSTAGES, 2>
            : &launch_linear_mma<LTILE_SMALL, LTILE_SMALL, 2, 2, LBK, LSTAGES,
                                 4>;
    return (int)launch(static_cast<const bf16*>(x), ldx,
                       static_cast<const bf16*>(w), bias, bias_dt,
                       static_cast<const bf16*>(res), static_cast<bf16*>(y),
                       M, N, K, stream);
  }
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  if (dt == SDM_F32)
    linear_nt<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), ldx, static_cast<const float*>(w), bias,
        bias_dt, static_cast<const float*>(res), static_cast<float*>(y), M, N,
        K);
  else
    linear_nt<bf16><<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(w), bias,
        bias_dt, static_cast<const bf16*>(res), static_cast<bf16*>(y), M, N,
        K);
  return (int)cudaGetLastError();
}
