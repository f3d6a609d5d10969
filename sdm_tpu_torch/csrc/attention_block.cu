// The attention block for heads == 1 in one C call:
//
//   qkv = tokens W_qkv^T + b_qkv          (linear_forward, the compute dtype)
//   r = attention(q, k, v)                (views of qkv; query or key axis)
//   out = (r W_out^T + b_out) + tokens    (rounded, then the residual added)
//
// Replaces the TPU kernel sdm_tpu/kernels/attention_block.py::
// fused_attention_block (_block_kernel :62-77, pallas_call at :88), which
// keeps qkv and r in VMEM. On the H100 qkv cannot stay on chip: the stats
// pass needs all of a sample's keys, across blocks. r can, wherever one
// apply block owns whole rows of it. So:
//
//   - bf16 at D = C = 512 with S >= BFUSED_MIN_S (block_route 2; the
//     flagship's and the SR model's (1024, 512) blocks): three launches,
//     linear_wgmma for qkv, attn_stats_wgmma, and attn_apply_wgmma<QAXIS, 4,
//     true>, the apply unsplit carrying the output projection, its bias and
//     the residual (attention_kernels.cuh). No r tensor exists.
//   - otherwise (fp32, bf16 shapes the tensor cores do not take, D = 768 or
//     1024, short S): four launches in turn, the qkv GEMM, the attention's
//     stats and apply into r, and the GEMM again with the residual epilogue,
//     each kernel as `linear` and `fused_attention` launch it alone.
//
// Every launch goes on the caller's stream from this one call, so a block
// costs the host one ctypes call. The kernels' sources are shared with
// linear.cu and attention.cu through linear_kernels.cuh and
// attention_kernels.cuh; each kernel has one copy.
//
// The block is bound by operations: 2 N S C 4 D for the projections and
// 4 N S^2 D for Q K^T and P V.
#include "linear_kernels.cuh"
#include "attention_kernels.cuh"

#define BFUSED_D 512       // the fused route's D = C: the apply unsplit
#ifndef BFUSED_MIN_S
#define BFUSED_MIN_S 1024  // its shortest S (tools/torch_block_tiles.py)
#endif

// Returned, launching nothing, when the scratch the caller passed is not
// the route's (block_scratch_elems).
#define SDM_ERR_SCRATCH (-2)

// The route of a block: 2 the fused one (bf16, D = C = BFUSED_D, S >=
// BFUSED_MIN_S, every operand as the tensor cores take it), 1 every kernel
// on the tensor cores in four launches, 0 some kernel on the CUDA cores.
// scratch is the qkv buffer (N, S, 3 D), then r (N, S, D) where route < 2.
static int block_route(const void* tok, const void* w_qkv, const void* w_out,
                       const void* out, const void* scratch, int N, int S,
                       int C, int D, int dt) {
  const bf16* q = static_cast<const bf16*>(scratch);
  const bf16* r = q + (long long)N * S * 3 * D;
  const View qkv{(long long)S * 3 * D, 3LL * D, 3LL * D};
  const View rv{(long long)S * D, D, D};
  const void* ptrs[4] = {q, q + D, q + 2 * D, r};
  const View views[4] = {qkv, qkv, qkv, rv};
  if (!linear_wgmma_ok(tok, C, w_qkv, nullptr, C, dt) ||
      !wgmma_ok(dt, ptrs, views, S, D) || !attention_fits(S, 1))
    return 0;
  if (D == BFUSED_D && C == BFUSED_D && S >= BFUSED_MIN_S &&
      aligned16(w_out) && aligned16(out))
    return 2;
  return linear_wgmma_ok(r, D, w_out, tok, D, dt) ? 1 : 0;
}

// Elements of the scratch of a route: qkv, and r unless the apply carries
// the output projection.
static long long block_scratch_elems(int N, int S, int D, int route) {
  return (long long)N * S * (route == 2 ? 3 : 4) * D;
}

// tokens and out (N, S, C) contiguous, w_qkv (3 D, C) and w_out (C, D) in
// the tokens' dtype, b_qkv (3 D) and b_out (C) of dtype codes bq_dt and
// bo_dt; scratch of scratch_elems elements of the tokens' dtype
// (block_scratch_elems of the route), stats of 2 N S floats. Returns
// cudaGetLastError() after the launches, SDM_ERR_TOKENS (S past the
// whole-S attention) or SDM_ERR_SCRATCH having launched nothing.
SDM_EXPORT int sdm_attention_block_forward(
    const void* tok, const void* w_qkv, const void* b_qkv, int bq_dt,
    const void* w_out, const void* b_out, int bo_dt, void* out, void* scratch,
    long long scratch_elems, float* stats, int N, int S, int C, int D,
    float scale, int axis_q, int dt, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int route = block_route(tok, w_qkv, w_out, out, scratch, N, S, C, D,
                                dt);
  if (scratch_elems != block_scratch_elems(N, S, D, route))
    return SDM_ERR_SCRATCH;
  const long long M = (long long)N * S;
  const size_t isz = dt == SDM_F32 ? 4 : 2;
  char* qkv = static_cast<char*>(scratch);
  const void* q = qkv;
  const void* k = qkv + D * isz;
  const void* v = qkv + 2 * D * isz;
  void* r = route == 2 ? out : qkv + M * 3 * D * isz;
  const View qkv_view{(long long)S * 3 * D, 3LL * D, 3LL * D};
  const View views[4] = {qkv_view, qkv_view, qkv_view,
                         View{(long long)S * D, D, D}};
  const void* ptrs[4] = {q, k, v, r};
  if (!attention_fits(S, wgmma_ok(dt, ptrs, views, S, D)))
    return SDM_ERR_TOKENS;
  int rc = linear_forward(tok, C, w_qkv, b_qkv, bq_dt, nullptr, qkv, (int)M,
                          3 * D, C, dt, stream);
  if (rc != 0) return rc;
  if (route == 2) {
    OutProj proj{};
    rc = sdm_tma_map_bf16(&proj.w, w_out, C, D, D, WOUT_ROWS);
    if (rc != 0) return rc;
    proj.bias = b_out;
    proj.res = static_cast<const bf16*>(tok);
    proj.bias_dt = bo_dt;
    proj.C = C;
    return launch_wgmma<true>(static_cast<const bf16*>(q),
                              static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v),
                              static_cast<bf16*>(out), stats, stats + M, views,
                              N, 1, S, D, scale, axis_q, stream, proj);
  }
  rc = attention_forward(q, k, v, r, stats, views, N, 1, S, D, scale, axis_q,
                         dt, stream);
  if (rc != 0) return rc;
  return linear_forward(r, D, w_out, b_out, bo_dt, tok, out, (int)M, C, D, dt,
                        stream);
}

// block_route for the Python mirror (kernels/attention_block.py::
// block_route), checked against it on the card.
SDM_EXPORT int sdm_attention_block_route(const void* tok, const void* w_qkv,
                                         const void* w_out, const void* out,
                                         const void* scratch, int N, int S,
                                         int C, int D, int dt) {
  return block_route(tok, w_qkv, w_out, out, scratch, N, S, C, D, dt);
}
