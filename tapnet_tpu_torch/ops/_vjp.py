"""Gradients of the hand-written kernels (the JAX package's custom VJPs).

Every kernel entry that the JAX package differentiates has a custom VJP
whose backward is the VJP of the entry's plain math, recomputed from the
saved inputs: `ops/corr_tents.py` (K1, K2, K2b), `ops/fused_mixer_block.py`
(K3, K4), `ops/fused_extra_convs.py` (K6, K6f), `ops/qconv.py` (X) and
`ops/mixer_math.py::mlp_block_q8`. The int8 forms are straight-through:
their backward is the VJP of the full-precision math.

`apply(forward, plain, *inputs)` is that pattern. The forward is the entry's
own (the kernel on CUDA tensors, the plain version on CPU tensors); the
backward recomputes `plain(*inputs)` under `torch.enable_grad()` on the same
device and returns its VJP. A kernel's output thus carries the same gradient
as its plain version's, bit for bit, whatever the forward ran on. Without a
gradient to record (no input requires one, or grad mode is off) the forward
runs alone and nothing is saved.
"""

from __future__ import annotations

from typing import Callable

import torch


class PlainVjp(torch.autograd.Function):
  """forward(*inputs), with the VJP of plain(*inputs) as its backward."""

  @staticmethod
  def forward(ctx, forward: Callable, plain: Callable, *inputs):
    ctx.plain = plain
    ctx.save_for_backward(*inputs)
    return forward(*inputs)

  @staticmethod
  def backward(ctx, grad):
    needs = ctx.needs_input_grad[2:]
    args = [
        x if x is None else x.detach().requires_grad_(need)
        for x, need in zip(ctx.saved_tensors, needs)
    ]
    wanted = [a for a, need in zip(args, needs) if need]
    with torch.enable_grad():
      out = ctx.plain(*args)
    got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
    grads = []
    for a, need in zip(args, needs):
      g = next(got) if need else None
      grads.append(torch.zeros_like(a) if need and g is None else g)
    return (None, None, *grads)


def apply(forward: Callable, plain: Callable, *inputs) -> torch.Tensor:
  """forward(*inputs), differentiable as plain(*inputs) (see the module
  docstring). `inputs` are tensors or None; the rest of each function's
  arguments are bound in the callables."""
  if torch.is_grad_enabled() and any(
      x is not None and x.requires_grad for x in inputs):
    return PlainVjp.apply(forward, plain, *inputs)
  return forward(*inputs)
