"""Backward passes that recompute through a plain version.

sdm_tpu's AdaGN, whole-S attention and attention-block kernels have no
backward kernel: their custom VJPs differentiate the XLA reference on the
saved inputs (sdm_tpu/kernels/adagn.py:167, attention.py:193,
attention_block.py:152). The port's `torch.autograd.Function`s do the same
with the plain PyTorch version: the forward launches the kernel, the
backward runs autograd through the plain version, so no activation of the
plain version is kept between the two.
"""

from __future__ import annotations

import torch


def recompute_backward(fn, saved, needs, grad_out):
    """Gradients of `fn(*saved)` against `grad_out` for the arguments whose
    flag in `needs` (ctx.needs_input_grad) is set, None for the others."""
    leaves = [t.detach().requires_grad_(bool(need)) if torch.is_tensor(t)
              else t for t, need in zip(saved, needs)]
    want = [t for t, need in zip(leaves, needs) if need]
    with torch.enable_grad():
        out = fn(*leaves)
    grads = iter(torch.autograd.grad(out, want, grad_out, allow_unused=True))
    return tuple(next(grads) if need else None for need in needs)


def wants_grad(*tensors) -> bool:
    """Whether autograd will differentiate a call on `tensors`."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if torch.is_tensor(t))
