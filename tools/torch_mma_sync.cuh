// The mma.sync building blocks and kernel that the port's library no
// longer runs, kept for the A/B sweeps in tools/ (torch_streaming_tiles.cu,
// torch_da_tiles.cu) as they stood in sdm_tpu_torch/csrc before the
// library moved every bf16 tensor-core kernel onto TMA + wgmma: plain
// inline PTX for sm_80+ (cp.async copies into shared memory, ldmatrix,
// mma.sync m16n8k16 bf16 with fp32 accumulation) and stream_apply_mma,
// the streaming apply kernel on them, which ran the forward's apply pass
// until stream_apply_wgmma and the backward's dV pass until
// stream_apply_wgmma<..., dv_pass>. Include it after the library source
// (it uses View, slice_ptr, rows_aligned16 and MAX_SMEM of
// attention_tiles.cuh).
#pragma once

// ------------------------------------------------------- mma.sync primitives

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

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// cp.async of `rows` rows x `cpr` 16-byte chunks of a row-major bf16 matrix
// (row stride ss elements) into dst[rows][ld]. This thread copies the chunks
// c = tid + nthreads * i of the row-major (rows, cpr) chunk grid, walked
// incrementally (no division in the loop).
__device__ __forceinline__ void cp_async_rows(bf16* dst, int ld,
                                              const bf16* src, long long ss,
                                              int rows, int cpr, int tid,
                                              int nthreads) {
  const int step_r = nthreads / cpr, step_c = nthreads - step_r * cpr;
  int r = tid / cpr, cc = tid - r * cpr;
  while (r < rows) {
    cp_async16(smem_u32(dst + r * ld + cc * 8), src + (long long)r * ss + cc * 8);
    r += step_r;
    cc += step_c;
    if (cc >= cpr) {
      cc -= cpr;
      ++r;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core apply: stream_apply_mma<OutT, QAXIS, Pass>, out[i] = sum_j
// round_bf16(exp(s_ij - m) / l) v_j with the final stats of the stats pass.
//
// Launched with the roles swapped it was the dV pass (the TPU's _dv_kernel,
// sdm_tpu/kernels/streaming_attention.py:133, pallas_call at :298); the
// library runs both passes on stream_apply_wgmma (streaming_attention.cu).
// Bound: operations,
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
