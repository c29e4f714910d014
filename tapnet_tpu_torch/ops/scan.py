"""The diagonal linear recurrence of the RG-LRU (port of
tapnet_tpu/ops/scan.py).

    h[t] = a[t] * h[t-1] + x[t],  h[-1] = h0

over axis 1 (time) of x, a [B, T, C], with a float32 carry. `linear_scan`
returns (y [B, T, C] in x's dtype, h_last [B, C] float32), as the JAX entry
does:

  * T == 1 takes the one-step formula and launches nothing;
  * CPU tensors run `linear_scan_reference`, a loop over T that mirrors the
    body of the TPU kernel (`_scan_kernel`): a multiply and an add in
    float32, each rounded, y rounded to x's dtype;
  * CUDA tensors launch K5, `linear_scan_forward` of `csrc/scan.cu`, which
    makes the same two roundings per step and so equals the plain version bit
    for bit. Inputs that require grad raise: the backward kernel (the same
    scan in reverse time) comes with training. Any other device raises.

`scan_controls` gives faulty plain versions (an FMA-contracted step, a
bfloat16 carry) that a bit-equality check must refuse.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tapnet_tpu_torch.ops import _build

# Number of CUDA launches of K5 made through `linear_scan`.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "linear_scan_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
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


def _launch(x, a, h0):
  global LAUNCHES
  if x.dtype not in _DTYPES or a.dtype != x.dtype:
    raise TypeError(
        f"linear_scan: x and a must share float32 or bfloat16, got {x.dtype}, "
        f"{a.dtype}"
    )
  if h0.dtype != torch.float32:
    raise TypeError(f"linear_scan: h0 must be float32, got {h0.dtype}")
  if x.ndim != 3 or a.shape != x.shape or h0.shape != (x.shape[0], x.shape[2]):
    raise ValueError(
        f"linear_scan: shapes x {tuple(x.shape)}, a {tuple(a.shape)}, h0 "
        f"{tuple(h0.shape)}"
    )
  if a.device != x.device or h0.device != x.device:
    raise ValueError("linear_scan inputs must share one CUDA device")
  if not (x.is_contiguous() and a.is_contiguous() and h0.is_contiguous()):
    raise ValueError("linear_scan inputs must be contiguous")
  if torch.is_grad_enabled() and (
      x.requires_grad or a.requires_grad or h0.requires_grad
  ):
    raise RuntimeError(
        "linear_scan: the CUDA kernel has no backward yet; run under "
        "torch.no_grad() or torch.inference_mode()"
    )
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


def linear_scan(
    x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """h[t] = a[t] * h[t-1] + x[t]; returns (y [B, T, C] in x.dtype, h_last
  [B, C] float32). h0 is [B, C] float32 (zeros for a fresh sequence)."""
  if x.shape[1] == 1:
    h = a[:, 0].float() * h0 + x[:, 0].float()
    return h[:, None].to(x.dtype), h
  device = x.device.type
  if device == "cpu":
    return linear_scan_reference(x, a, h0)
  if device == "cuda":
    return _launch(x, a, h0)
  raise ValueError(f"linear_scan: unsupported device {x.device}")
