// The attention block's one C call (sdm_tpu_torch/csrc/attention_block.cu)
// built with the fused route's shortest S set on nvcc's command line, for
// tools/torch_block_tiles.py: with -DBFUSED_MIN_S=256 the flagship's
// (256, 512) block takes the fused route (the apply unsplit, carrying the
// output projection, three launches), where the library's rule runs it in
// four launches (the apply at wgmma_plan's split 2, then the GEMM).
#include "../sdm_tpu_torch/csrc/attention_block.cu"
