// The port's AdaGN forward (sdm_tpu_torch/csrc/adagn.cu) with its route left
// open, for tools/torch_adagn_tiles.py. The one-pass plan's settings (the
// bytes of a bulk copy, the ring's slots, the bytes of the samples in flight
// that set the teams) are adagn.cu's ADAGN_PIECE, ADAGN_SLOTS and
// ADAGN_TEAM_BYTES: the sweep builds this file once for each set it times,
// with -D. A block takes whole rows of a sample, all C channels (every
// group), so its rows are one contiguous range, read by bulk copies without
// a tensor map.
#include "../sdm_tpu_torch/csrc/adagn.cu"

// Returned, launching nothing, where the shape does not take the plan
// asked for.
#define TILES_ERR_PLAN (-1)

// One bf16 call on the plan of `route` (-1: the entry point's plan; 0 the
// two passes; 1 the one-pass kernel, TILES_ERR_PLAN where the entry point
// would not take it); plan[0..5] receives the plan as sdm_adagn_plan writes
// it. scratch and counters as sdm_adagn_forward's. Returns 0,
// TILES_ERR_PLAN or a cudaError_t.
SDM_EXPORT int tiles_adagn(const void* x, const void* gamma, const void* beta,
                           const void* s, const void* t, void* out,
                           float* scratch, long long scratch_floats,
                           unsigned long long* counters, long long n_counters,
                           int n, int hw, int c, int groups, float eps,
                           long long f_row_stride, int route, int* plan,
                           void* stream_ptr) {
  AdagnPlan pl =
      make_plan(n, hw, c, groups, SDM_BF16, SDM_BF16, device_sms());
  if (route == ADAGN_TWO_PASS) {
    const int chunks = adagn_chunks(n, hw, groups);
    pl = AdagnPlan{ADAGN_TWO_PASS, chunks * n, 0, 0, 0, chunks};
  } else if (route == ADAGN_ONE_PASS && pl.route != ADAGN_ONE_PASS) {
    return TILES_ERR_PLAN;
  }
  write_plan(pl, plan);
  return run_plan(pl, x, gamma, beta, s, t, out, scratch, scratch_floats,
                  counters, n_counters, n, hw, c, groups, eps, f_row_stride,
                  SDM_BF16, SDM_BF16, SDM_BF16, SDM_BF16,
                  static_cast<cudaStream_t>(stream_ptr));
}
