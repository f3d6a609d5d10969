// The whole-S attention alone, `fused_attention` (kernels/attention.py):
// the kernels of attention_kernels.cuh (the tensor-core stats and apply,
// attn_stats_wgmma and attn_apply_wgmma, or the CUDA-core ones) behind a C
// entry point, with the admission, plan and shared memory of the
// tensor-core path exported for their Python mirrors.
#include "attention_kernels.cuh"

// strides: 12 int64 values, (sn, sh, ss) of q, k, v and out in elements.
// stats: fp32 scratch of 2*batch*heads*S floats.
// Returns cudaGetLastError() after the launches (0 = success), or
// SDM_ERR_TOKENS, having launched nothing, when S is too long.
SDM_EXPORT int sdm_attention_forward(const void* q, const void* k,
                                     const void* v, void* o, float* stats,
                                     const long long* strides, int batch,
                                     int heads, int S, int D, float scale,
                                     int axis_q, int dt, void* stream_ptr) {
  View views[4];
  read_views(strides, views, 4);
  return attention_forward(q, k, v, o, stats, views, batch, heads, S, D,
                           scale, axis_q, dt,
                           static_cast<cudaStream_t>(stream_ptr));
}

// Whether sdm_attention_forward takes S: on the tensor-core path
// (tensor_cores != 0) S <= WHOLE_S_MAX_MMA, on the CUDA-core path when the
// apply pass's 32 x S block fits in shared memory. kernels/attention.py
// mirrors this to choose between this kernel and the streaming one;
// chip_smoke.py holds the two against each other.
SDM_EXPORT int sdm_attention_fits(int S, int tensor_cores) {
  return attention_fits(S, tensor_cores);
}

// The admission, the plan and the shared memory of the tensor-core path,
// for the Python mirrors in kernels/attention.py (checked against these on
// the card). ptrs: q, k, v, out; strides as sdm_attention_forward takes
// them.
SDM_EXPORT int sdm_attention_takes_wgmma(const void* const* ptrs,
                                         const long long* strides, int S,
                                         int D, int dt) {
  View views[4];
  read_views(strides, views, 4);
  return wgmma_ok(dt, ptrs, views, S, D);
}

// plan: two ints, (split, cols) of wgmma_plan.
SDM_EXPORT int sdm_attention_wgmma_plan(int bh, int S, int D, int* plan) {
  wgmma_plan(bh, S, D, plan, plan + 1);
  return 0;
}

// smem: four ints, the stats and the apply kernel's dynamic shared memory
// at D and their ring stages.
SDM_EXPORT int sdm_attention_wgmma_smem(int D, int* smem) {
  smem[0] = (int)wgmma_stats_smem_bytes(D);
  smem[1] = (int)wgmma_apply_smem_bytes(D);
  smem[2] = wgmma_stats_stages(D);
  smem[3] = wgmma_apply_stages(D);
  return 0;
}
