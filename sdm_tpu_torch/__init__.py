"""sdm_tpu_torch — the PyTorch/CUDA port of sdm_tpu for NVIDIA Hopper.

A second package beside `sdm_tpu` (the JAX/TPU reference, which it never
imports). Module paths mirror `sdm_tpu` so each port module sits where its
counterpart does. Plain tensor code is PyTorch; every Pallas kernel of the
served path is a hand-written CUDA kernel for sm_90a (sources in `csrc/`,
built with nvcc at first use by `kernels/_build.py`, bound with ctypes).

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors the kernel wrappers run their plain PyTorch
versions.

The port covers serving: the U-Net forward, the DDIM/DDPM and cold
samplers, the bundle format, the HTTP server for BASE, BASE-COLD and SR
bundles, and the SR and cold generators. Training and the extensions are
later slices.
"""

__version__ = "0.1.0"
