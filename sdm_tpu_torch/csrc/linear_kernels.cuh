// Tiled GEMM with a bias (+ residual) epilogue: y = T(x W^T + b) [+ res].
//
// The projections of the attention block, which the TPU kernel
// sdm_tpu/kernels/attention_block.py::fused_attention_block computes in its
// own body (_block_kernel: qkv = tok W_qkv + b at :66, out = r W_out + b_out
// + tok at :76). On the H100 the block's weights (W_qkv alone is 512 x 1536)
// do not fit one SM next to the token tile, so the block's one C call
// (attention_block.cu) launches this GEMM for the qkv projection, and again
// with the residual epilogue for the output projection wherever the
// attention's apply does not carry that projection itself
// (attention_kernels.cuh). linear.cu exports it alone, for `linear()` (the
// composed streaming block).
//
// Rounding follows the JAX composite (_xla_block, attention_block.py:121-131):
// fp32 accumulation, fp32 bias added, one rounding to T; the residual is
// added to that rounded value in fp32 and rounded again (JAX adds the tokens
// in the compute dtype).
//
// x is (M, K) with row stride ldx and a unit column stride; w is the
// nn.Linear weight (N, K), contiguous. Two paths:
//   - bf16 with K % 8 == 0, ldx % 8 == 0 and 16-byte aligned x, w and
//     residual (linear_wgmma_ok; every U-Net projection): linear_wgmma,
//     TMA + wgmma on the tensor cores, below;
//   - otherwise linear_nt: fp32 FMA on the CUDA cores, 64 x 64 tiles with a
//     4 x 4 register tile per thread.
#pragma once

#include "wgmma_tiles.cuh"

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
// Tensor-core path: linear_wgmma, bf16 in and out, fp32 accumulation.
//
// Bound: operations, 2 M N K against (M K + N K + M N) * 2 bytes: at the
// flagship's qkv projection (M = 16384, N = 1536, K = 512) about 390
// operations per byte, above the H100's ~295 for bf16.
//
// Block: BM x BN output tiles, BM = 64 WG, run by WG consumer warpgroups
// (warps 0 .. 4 WG - 1, each owning 64 rows) and one producer warp (the
// last). The grid is persistent: LBLOCKS blocks an SM (at most one a tile)
// walk the tiles blockIdx.x, + gridDim.x, ... (N fastest). Shared memory
// is a ring of STAGES stages, each a tile's x rows (BM x 64) and W rows
// (BN x 64) for 64 columns of K, bf16, as TMA writes them with the
// 128-byte swizzle (wgmma_tiles.cuh), every tile 1024-byte aligned. Each
// stage has a "full" mbarrier (the producer's arrival plus the stage's TMA
// bytes) and an "empty" one (lane 0 of every consumer warp). One thread of
// the producer warp walks the block's tiles and their K steps: it waits for
// the stage to be empty, announces its bytes and issues the two TMA loads,
// running up to STAGES steps ahead, into the next tile while the consumers
// store the last. Each consumer warpgroup waits for the stage to be full
// and issues four wgmma m64nBNk16 on it (its 64 x rows against all BN W
// rows, the descriptor start advanced 32 bytes per 16-deep step), commits
// them as one group and waits until only that group is in flight: the
// previous stage's products have then retired, and the warpgroup releases
// that stage. The fp32 accumulators (BN / 2 a thread) stay in registers to
// the tile's end. The producer is one warp, not a warpgroup, so ptxas has
// 112 registers a thread at two 288-thread blocks an SM without setmaxnreg.
//
// TMA zero-fills rows past M or N and columns past K in every box, so
// ragged M and N and a K that is not a multiple of 64 need no other path:
// the zero columns add exact zeros. The admission needs only what TMA
// needs: 16-byte aligned x and W and row strides of x and W that are
// multiples of 16 bytes (ldx % 8 == 0, K % 8 == 0).
//
// The epilogue works on the accumulator fragments (warp w of the
// warpgroup, lane 4 g + t: rows 16 w + g and 16 w + g + 8, columns 8 j +
// 2 t and 8 j + 2 t + 1): bias added in fp32 and the pair rounded to
// bf16x2; where N % 8 == 0 the quad then transposes four 8-column blocks
// so that each lane holds eight consecutive columns, adds the residual's
// eight in fp32, rounds again and stores 16 bytes (a warp writes 64
// contiguous bytes a row); otherwise pairs (singles where N is odd) as
// linear_mma did. Rows past M and columns past N are masked.
//
// What this design does about linear_mma's ceiling: that kernel fed
// mma.sync m16n8k16 from registers, every operand fragment loaded by
// ldmatrix and every copy issued by all threads through cp.async, and with
// no memory traffic at all it ran at 216-385 TFLOP/s. Here no thread loads
// an operand: TMA writes the tiles, wgmma reads them from shared memory in
// 64-row products, and the consumer warps only wait, issue and store.
//
// Tiles, from the sweep (tools/torch_linear_tiles.py, H100 SXM 700 W): 128
// x 128 with 3 stages, two blocks an SM, persistent, wherever that grid has
// at least LSMS tiles; 128 x 64 with 4 stages, two blocks an SM, below
// (M = 1024, N = 1024: 64 tiles of 128 x 128 for 132 SMs). Against one
// block a tile, 128 x 256 or 64 x 128 blocks, 3 to 5 stages and one block
// an SM, it had the least time summed over each U-Net's projections; the
// 16-byte epilogue took about 30 % off that sum (against storing each
// pair's 4 bytes), persistence about 3 % more.
// ---------------------------------------------------------------------------

#define LBK 64               // K depth of a ring stage: one swizzled row
#define LWG 2                // consumer warpgroups of the large tile
#define LBN 128              // its width
#define LSTAGES 3            // its ring depth
#define LWG_SMALL 2          // the tile where the large one's grid is short
#define LBN_SMALL 64
#define LSTAGES_SMALL 4
#define LBLOCKS 2            // blocks an SM, of either tile
#define LSMS 132             // SMs of the H100

// linear_wgmma's admission. res may be null.
static bool linear_wgmma_ok(const void* x, long long ldx, const void* w,
                            const void* res, int K, int dt) {
  return dt == SDM_BF16 && K > 0 && K % 8 == 0 && ldx % 8 == 0 &&
         aligned16(x) && aligned16(w) && (res == nullptr || aligned16(res));
}

// 0 for the large tile, 1 for the small one.
static int linear_wgmma_tile(int M, int N) {
  const long long tiles = (long long)((M + 64 * LWG - 1) / (64 * LWG)) *
                          ((N + LBN - 1) / LBN);
  return tiles >= LSMS ? 0 : 1;
}

// Dynamic shared memory of a tile: alignment slack, the ring, the barriers.
static size_t linear_wgmma_smem(int BM, int BN, int STAGES) {
  return 1024 + (size_t)STAGES * (BM + BN) * LBK * sizeof(bf16) +
         2 * STAGES * sizeof(uint64_t);
}

template <int BN, int WG, int STAGES, int MINB, bool VEC>
__global__ void __launch_bounds__(128 * WG + 32, MINB)
linear_wgmma(const __grid_constant__ CUtensorMap tmx,
             const __grid_constant__ CUtensorMap tmw,
             const void* __restrict__ bias, int bias_dt,
             const bf16* __restrict__ res, bf16* __restrict__ y, int M,
             int N, int K, int tiles, int tiles_n) {
  constexpr int BM = 64 * WG;
  constexpr int X_BYTES = BM * LBK * 2, W_BYTES = BN * LBK * 2;
  constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
                "every tile 1024-byte aligned");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ksteps = (K + LBK - 1) / LBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block walks output tiles blockIdx.x, + gridDim.x, ... (N fastest);
  // `it` counts ring steps over all of them: step it uses stage it %
  // STAGES, whose barriers then complete for the (it / STAGES)-th time.
  if (warp == 4 * WG) {
    // The producer: stage it % STAGES <- K columns [64 ks, +64) of the
    // tile's x and W rows, once the consumers released its previous use
    // (step it - STAGES).
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          unsigned char* xs = ring + st * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
          tma_load_2d(xs, &tmx, &full[st], ks * LBK, m0);
          tma_load_2d(xs + X_BYTES, &tmw, &full[st], ks * LBK, n0);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows [64 wg, +64) of each tile.
  const int wg = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const unsigned char* xs = ring + st * STAGE_BYTES;
      const uint64_t da = wgmma_desc(xs + wg * 64 * LBK * 2);
      const uint64_t db = wgmma_desc(xs + X_BYTES);
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LBK / 16; ++kk)
        wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_fence_operands(acc);
      // Step it - 1's group has retired: its stage is free.
      wgmma_wait<1>();
      wgmma_fence_operands(acc);
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // Epilogue straight from the fragments, while the producer fills the
    // ring for the next tile.
    const int row0 = m0 + wg * 64 + (warp & 3) * 16 + g;
    if (VEC && N % 8 == 0) {
      // Per four 8-column blocks: each lane rounds its pairs (with the
      // bias) to bf16x2, the quad transposes them so that lane t holds
      // block 4 q + t's eight columns, and each lane adds the residual's
      // eight and stores 16 bytes: a warp writes 64 contiguous bytes a row.
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        unsigned pk[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj, col = n0 + 8 * j + 2 * tg;
          const bool in = col < N;   // N % 8 == 0: then col + 1 < N too
          const float b0 = in ? sdm_load(bias, col, bias_dt) : 0.f;
          const float b1 = in ? sdm_load(bias, col + 1, bias_dt) : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pk[hh][jj] = pack_bf16x2(acc[4 * j + 2 * hh] + b0,
                                     acc[4 * j + 2 * hh + 1] + b1);
        }
        const int col8 = n0 + 32 * q + 8 * tg;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          quad_transpose4(pk[hh], tg);
          const int row = row0 + 8 * hh;
          if (row >= M || col8 >= N) continue;
          const long long o = (long long)row * N + col8;
          if (res != nullptr) {
            float v[8], r[8];
            unpack_bf16x8(pk[hh], v);
            sdm_load8(res + o, r);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += r[e];
            sdm_store8(y + o, v);
          } else {
            *reinterpret_cast<uint4*>(y + o) =
                make_uint4(pk[hh][0], pk[hh][1], pk[hh][2], pk[hh][3]);
          }
        }
      }
      continue;
    }
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tg;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float b0 = sdm_load(bias, col, bias_dt);
      const float b1 = two ? sdm_load(bias, col + 1, bias_dt) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= M) continue;
        const long long o = (long long)row * N + col;
        float v0 = sdm_round<bf16>(acc[4 * j + 2 * hh] + b0);
        float v1 = sdm_round<bf16>(acc[4 * j + 2 * hh + 1] + b1);
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
}

// One launch of linear_wgmma<BN, WG, STAGES, MINB, VEC> on an (M, N)
// output, its tiles covering grid_m x grid_n: M x N, except in the tile
// sweep (tools/torch_linear_tiles.cu), which times the full grid on a 1 x 1
// output (every box zero-filled, no memory traffic). At most max_blocks
// blocks walk the tiles (0: one block a tile). The TMA maps are encoded
// here, per launch (x's pointer changes every call), and travel as
// __grid_constant__ parameters.
template <int BN, int WG, int STAGES, int MINB, bool VEC>
static int launch_linear_wgmma(const bf16* x, long long ldx, const bf16* w,
                               const void* bias, int bias_dt, const bf16* res,
                               bf16* y, int M, int N, int K,
                               cudaStream_t stream, int grid_m, int grid_n,
                               int max_blocks) {
  constexpr int BM = 64 * WG;
  CUtensorMap tmx, tmw;
  int rc = sdm_tma_map_bf16(&tmx, x, M, K, ldx, BM);
  if (rc == 0) rc = sdm_tma_map_bf16(&tmw, w, N, K, K, BN);
  if (rc != 0) return rc;
  auto kernel = &linear_wgmma<BN, WG, STAGES, MINB, VEC>;
  const size_t smem = linear_wgmma_smem(BM, BN, STAGES);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int tiles_n = (grid_n + BN - 1) / BN;
  const int tiles = (grid_m + BM - 1) / BM * tiles_n;
  const int blocks =
      max_blocks > 0 && max_blocks < tiles ? max_blocks : tiles;
  kernel<<<blocks, 128 * WG + 32, smem, stream>>>(
      tmx, tmw, bias, bias_dt, res, y, M, N, K, tiles, tiles_n);
  return (int)cudaGetLastError();
}

// y = T(x W^T + b) [+ res] on the stream: linear_wgmma where linear_wgmma_ok
// admits the operands, else linear_nt. res may be null. Returns
// cudaGetLastError() after the launch, or the error of encoding the TMA
// maps.
static int linear_forward(const void* x, long long ldx, const void* w,
                          const void* bias, int bias_dt, const void* res,
                          void* y, int M, int N, int K, int dt,
                          cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (linear_wgmma_ok(x, ldx, w, res, K, dt)) {
    auto launch =
        linear_wgmma_tile(M, N) == 0
            ? &launch_linear_wgmma<LBN, LWG, LSTAGES, LBLOCKS, true>
            : &launch_linear_wgmma<LBN_SMALL, LWG_SMALL, LSTAGES_SMALL,
                                   LBLOCKS, true>;
    return launch(static_cast<const bf16*>(x), ldx,
                  static_cast<const bf16*>(w), bias, bias_dt,
                  static_cast<const bf16*>(res), static_cast<bf16*>(y), M, N,
                  K, stream, M, N, LBLOCKS * LSMS);
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
