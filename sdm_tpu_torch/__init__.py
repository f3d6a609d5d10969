"""sdm_tpu_torch — the PyTorch/CUDA port of sdm_tpu for NVIDIA Hopper.

A second package beside `sdm_tpu` (the JAX/TPU reference, which it never
imports). Module paths mirror `sdm_tpu` so each port module sits where its
counterpart does. Plain tensor code is PyTorch; every Pallas kernel of the
served path is a hand-written CUDA kernel for sm_90a (sources in `csrc/`,
built with nvcc at first use by `kernels/_build.py`, bound with ctypes).

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors the kernel wrappers run their plain PyTorch
versions.

The port covers the user flow of sdm_tpu's main path: the config wizards,
the four trainers (base, cold, doodle, SR), export, the DDIM/DDPM, cold and
SR generators, and the HTTP server for BASE, BASE-COLD and SR bundles, with
the extensions, distillation, eval and data-parallel training, serving and
generation (`parallel/`). Tensor and spatial partitioning are later
slices.
"""

__version__ = "0.1.0"
