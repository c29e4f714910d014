"""Local correlation + bilinear-tent patches (port of tapnet_tpu/ops/corr_tents.py).

`corr_tent_patches` keeps the JAX public layout: grid [BT, H, W, C] and
query [BT, N, C] in the compute dtype, centres cy/cx [BT, N] float32 in grid
index space (raster - 0.5), output [BT, p, p, N] float32.

  * CPU tensors run `corr_tent_patches_reference`, the port of the JAX
    `_math_reference` (correlation einsum rounded to the compute dtype, tent
    contractions with float32 accumulation).
  * CUDA tensors launch the hand-written kernel `csrc/corr_tents.cu`, which
    computes only the (p+1) x (p+1) correlation window each patch needs.
  * Anything else raises. There is no size gate and no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from tapnet_tpu_torch.ops import _build

# Number of CUDA kernel launches made through `corr_tent_patches`.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "corr_tents_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}


def _tent_weights(coords: torch.Tensor, size: int, p: int) -> torch.Tensor:
  """[..., p, size] separable tents relu(1 - |c + d - i|)."""
  offsets = (
      torch.arange(p, dtype=coords.dtype, device=coords.device) - (p - 1) / 2
  )
  cells = torch.arange(size, dtype=coords.dtype, device=coords.device)
  centers = coords[..., None] + offsets
  return torch.relu(1.0 - (centers[..., None] - cells).abs())


def corr_tent_patches_reference(
    grid: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Plain version: [BT, H, W, C] x [BT, N, C] -> [BT, p, p, N] float32.

  The correlation is accumulated in float32 and rounded to the compute
  dtype; the y-tent stage is rounded to the compute dtype again before the
  x-tent stage, as in the JAX reference.
  """
  dtype = grid.dtype
  corrs = torch.einsum("bhwc,bnc->bnhw", grid.float(), query.float()).to(dtype)
  h, w = grid.shape[1:3]
  wy = _tent_weights(cy.float(), h, p).to(dtype)  # [BT, N, p, H]
  wx = _tent_weights(cx.float(), w, p).to(dtype)  # [BT, N, p, W]
  pat = torch.einsum("bnph,bnhw->bnpw", wy.float(), corrs.float()).to(dtype)
  pat = torch.einsum("bnqw,bnpw->bnpq", wx.float(), pat.float())
  return pat.permute(0, 2, 3, 1)


def _launch(grid, query, cy, cx, p):
  global LAUNCHES
  if p != 7:
    raise ValueError(f"The CUDA corr-tents kernel is built for p=7, got {p}.")
  if grid.dtype not in _DTYPES or query.dtype != grid.dtype:
    raise TypeError(
        f"grid/query must share float32 or bfloat16, got {grid.dtype}, "
        f"{query.dtype}"
    )
  if cy.dtype != torch.float32 or cx.dtype != torch.float32:
    raise TypeError("cy/cx must be float32")
  bt, h, w, c = grid.shape
  n = query.shape[1]
  if query.shape != (bt, n, c) or cy.shape != (bt, n) or cx.shape != (bt, n):
    raise ValueError(
        f"shapes grid {tuple(grid.shape)}, query {tuple(query.shape)}, "
        f"cy {tuple(cy.shape)}, cx {tuple(cx.shape)}"
    )
  tensors = (grid, query, cy, cx)
  if any(t.device != grid.device for t in tensors):
    raise ValueError("corr_tent_patches inputs must share one CUDA device")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("corr_tent_patches inputs must be contiguous")
  lib = _build.load("corr_tents", _SIGNATURES)
  out = torch.empty((bt, p, p, n), dtype=torch.float32, device=grid.device)
  stream = torch.cuda.current_stream(grid.device).cuda_stream
  with torch.cuda.device(grid.device):
    err = lib.corr_tents_forward(
        grid.data_ptr(), query.data_ptr(), cy.data_ptr(), cx.data_ptr(),
        out.data_ptr(), bt, h, w, c, n, p, _DTYPES[grid.dtype], stream,
    )
  _build.check(lib, err, "corr_tents_forward")
  LAUNCHES += 1
  return out


def corr_tent_patches(
    grid: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Correlation patches around track positions.

  Args:
    grid: [BT, H, W, C] feature grids (one per (batch, frame)).
    query: [BT, N, C] per-frame query descriptors, grid's dtype.
    cy / cx: [BT, N] float32 patch centres in grid index space.
    p: patch size (odd; the CUDA kernel is built for 7).

  Returns:
    [BT, p, p, N] float32 tent-interpolated correlation patches.
  """
  if grid.device.type == "cpu":
    return corr_tent_patches_reference(grid, query, cy, cx, p)
  if grid.device.type == "cuda":
    return _launch(grid, query, cy, cx, p)
  raise ValueError(f"corr_tent_patches: unsupported device {grid.device}")
