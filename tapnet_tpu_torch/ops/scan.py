"""The diagonal linear recurrence of the RG-LRU (port of
tapnet_tpu/ops/scan.py).

    h[t] = a[t] * h[t-1] + x[t],  h[-1] = h0

over axis 1 (time) of x, a [B, T, C], with a float32 carry. `linear_scan`
returns (y [B, T, C] in x's dtype, h_last [B, C] float32), as the JAX entry
does, and is differentiable in x, a and h0:

  * T == 1 takes the one-step formula (plain autograd) and launches nothing;
  * CPU tensors run `linear_scan_reference`, a loop over T that mirrors the
    body of the TPU kernel (`_scan_kernel`): a multiply and an add in
    float32, each rounded, y rounded to x's dtype; the backward runs
    `linear_scan_backward_reference`, the reverse-time recurrence of the
    JAX package's `_scan_bwd` in its order of operations;
  * CUDA tensors launch K5, `linear_scan_forward` of `csrc/scan.cu`, and in
    the backward K5b, `linear_scan_backward`; each makes the same roundings
    as its plain version and so equals it bit for bit. Any other device
    raises.

`scan_controls` and `scan_backward_controls` give faulty plain versions that
a bit-equality check must refuse.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from tapnet_tpu_torch.ops import _build

# Number of CUDA launches of K5 (forward) and K5b (backward) made through
# `linear_scan`.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "linear_scan_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "linear_scan_backward": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def linear_scan_reference(
    x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version: one float32 multiply and one add per step."""
  h = h0.float()
  ys = []
  for t in range(x.shape[1]):
    h = a[:, t].float() * h + x[:, t].float()
    ys.append(h.to(x.dtype))
  return torch.stack(ys, 1), h


def scan_controls(
    x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
  """Faulty plain versions, each as (y, h_last): the step contracted into
  one rounding (the product and sum in float64, rounded once to float32, as
  an FMA), and the carry rounded to bfloat16 at every step."""
  h_fma = h0.double()
  h_bf16 = h0.float()
  fma, bf16 = [], []
  for t in range(x.shape[1]):
    at, xt = a[:, t].float(), x[:, t].float()
    h_fma = (at.double() * h_fma + xt.double()).float().double()
    h_bf16 = (at * h_bf16 + xt).bfloat16().float()
    fma.append(h_fma.to(x.dtype))
    bf16.append(h_bf16.to(x.dtype))
  return {"fma_contracted": (torch.stack(fma, 1), h_fma.float()),
          "bf16_carry": (torch.stack(bf16, 1), h_bf16)}


def linear_scan_backward_reference(
    dy: Optional[torch.Tensor], dh_last: Optional[torch.Tensor],
    a: torch.Tensor, h0: torch.Tensor, y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The plain backward, in the order of the JAX package's `_scan_bwd`:

    g[T-1] = dy[T-1] + dh_last;  g[t] = a[t+1] * g[t+1] + dy[t]

  in float32, one multiply and one add per step; dx = g and da = g * h[t-1]
  in x's dtype, with h[t-1] = y[t-1] and h0 rounded to y's dtype at t = 0;
  dh0 = a[0] * g[0] in float32. dy or dh_last may be None (no cotangent).
  Returns (dx, da, dh0)."""
  dyf = (torch.zeros(y.shape, dtype=torch.float32, device=y.device)
         if dy is None else dy.float())
  steps = y.shape[1]
  g = dyf[:, steps - 1]
  if dh_last is not None:
    g = g + dh_last.float()
  gs = [g]
  for t in range(steps - 2, -1, -1):
    g = a[:, t + 1].float() * g + dyf[:, t]
    gs.append(g)
  g = torch.stack(gs[::-1], 1)
  h_prev = torch.cat([h0[:, None].to(y.dtype), y[:, :-1]], 1)
  dx = g.to(y.dtype)
  da = (g * h_prev.float()).to(a.dtype)
  dh0 = a[:, 0].float() * g[:, 0]
  return dx, da, dh0


def scan_backward_controls(
    dy: torch.Tensor, dh_last: torch.Tensor, a: torch.Tensor,
    h0: torch.Tensor, y: torch.Tensor,
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
  """Faulty plain backwards, each as (dx, da, dh0): the step contracted into
  one rounding (as an FMA), dh_last dropped, the decay of the same step
  a[t] used in place of a[t+1], and (in bfloat16 I/O) h0 left unrounded in
  da's first step."""
  steps = y.shape[1]
  dyf = dy.float()
  last = dyf[:, -1] + dh_last.float()

  def walk(step, g):
    gs = [g]
    for t in range(steps - 2, -1, -1):
      g = step(t, g)
      gs.append(g)
    return torch.stack(gs[::-1], 1)

  def finish(g, h_first):
    h_prev = torch.cat([h_first[:, None].float(), y[:, :-1].float()], 1)
    return (g.to(y.dtype), (g * h_prev).to(a.dtype), a[:, 0].float() * g[:, 0])

  h0_rounded = h0.to(y.dtype)
  fma = walk(lambda t, g: (a[:, t + 1].double() * g.double()
                           + dyf[:, t].double()).float(), last)
  out = {
      "fma_contracted": finish(fma, h0_rounded),
      "drops_dh_last": finish(
          walk(lambda t, g: a[:, t + 1].float() * g + dyf[:, t], dyf[:, -1]),
          h0_rounded),
      "a_t_for_a_t_plus_1": finish(
          walk(lambda t, g: a[:, t].float() * g + dyf[:, t], last), h0_rounded),
  }
  if y.dtype != torch.float32:
    exact = walk(lambda t, g: a[:, t + 1].float() * g + dyf[:, t], last)
    out["h0_unrounded"] = finish(exact, h0)
  return out


def _check(what, tensors, shape):
  """Raises on what the kernels do not take: tensors of one CUDA device, x,
  a and y in float32 or bfloat16 of one dtype, [B, T, C] and contiguous."""
  ref = tensors[0]
  if ref.dtype not in _DTYPES or any(t.dtype != ref.dtype for t in tensors):
    raise TypeError(
        f"{what}: x and a must share float32 or bfloat16, got "
        f"{[t.dtype for t in tensors]}"
    )
  if ref.ndim != 3 or any(tuple(t.shape) != tuple(shape) for t in tensors):
    raise ValueError(
        f"{what}: shapes {[tuple(t.shape) for t in tensors]}, expected "
        f"{tuple(shape)}"
    )
  if any(t.device != ref.device for t in tensors):
    raise ValueError(f"{what} inputs must share one CUDA device")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f"{what} inputs must be contiguous")


def _check_state(what, h, like):
  if h.dtype != torch.float32:
    raise TypeError(f"{what}: the state must be float32, got {h.dtype}")
  if tuple(h.shape) != (like.shape[0], like.shape[2]):
    raise ValueError(f"{what}: state of shape {tuple(h.shape)} for "
                     f"{tuple(like.shape)}")
  if h.device != like.device or not h.is_contiguous():
    raise ValueError(f"{what}: the state must be contiguous on {like.device}")


def _launch(x, a, h0):
  global LAUNCHES
  _check("linear_scan", (x, a), x.shape)
  _check_state("linear_scan", h0, x)
  rows, steps, width = x.shape
  lib = _build.load("scan", _SIGNATURES)
  y = torch.empty_like(x)
  h_last = torch.empty((rows, width), dtype=torch.float32, device=x.device)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  with torch.cuda.device(x.device):
    err = lib.linear_scan_forward(
        x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), rows, steps, width, _DTYPES[x.dtype], stream,
    )
  _build.check(lib, err, "linear_scan_forward")
  LAUNCHES += 1
  return y, h_last


def _launch_backward(dy, dh_last, a, h0, y):
  """K5b. dy and dh_last may be None (autograd passes no cotangent)."""
  global BACKWARD_LAUNCHES
  dy = torch.zeros_like(y) if dy is None else dy.contiguous()
  _check("linear_scan backward", (dy, a, y), y.shape)
  _check_state("linear_scan backward", h0, y)
  if dh_last is not None:
    dh_last = dh_last.contiguous()
    _check_state("linear_scan backward", dh_last, y)
  rows, steps, width = y.shape
  lib = _build.load("scan", _SIGNATURES)
  dx = torch.empty_like(y)
  da = torch.empty_like(a)
  dh0 = torch.empty((rows, width), dtype=torch.float32, device=y.device)
  stream = torch.cuda.current_stream(y.device).cuda_stream
  with torch.cuda.device(y.device):
    err = lib.linear_scan_backward(
        dy.data_ptr(), a.data_ptr(), y.data_ptr(), h0.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
        da.data_ptr(), dh0.data_ptr(), rows, steps, width, _DTYPES[y.dtype],
        stream,
    )
  _build.check(lib, err, "linear_scan_backward")
  BACKWARD_LAUNCHES += 1
  return dx, da, dh0


class _LinearScan(torch.autograd.Function):
  """The scan with its reverse-time backward: K5 and K5b on CUDA tensors,
  the plain versions on CPU tensors."""

  @staticmethod
  def forward(ctx, x, a, h0):
    if x.device.type == "cuda":
      y, h_last = _launch(x, a, h0)
    else:
      y, h_last = linear_scan_reference(x, a, h0)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(a, h0, y)
    return y, h_last

  @staticmethod
  def backward(ctx, dy, dh_last):
    a, h0, y = ctx.saved_tensors
    if dy is None and dh_last is None:
      return None, None, None
    if y.device.type == "cuda":
      return _launch_backward(dy, dh_last, a, h0, y)
    return linear_scan_backward_reference(dy, dh_last, a, h0, y)


def linear_scan(
    x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """h[t] = a[t] * h[t-1] + x[t]; returns (y [B, T, C] in x.dtype, h_last
  [B, C] float32). h0 is [B, C] float32 (zeros for a fresh sequence)."""
  if x.shape[1] == 1:
    h = a[:, 0].float() * h0 + x[:, 0].float()
    return h[:, None].to(x.dtype), h
  if x.device.type not in ("cpu", "cuda"):
    raise ValueError(f"linear_scan: unsupported device {x.device}")
  return _LinearScan.apply(x, a, h0)
