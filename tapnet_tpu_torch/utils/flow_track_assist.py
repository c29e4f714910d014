"""Optical-flow-assisted point-track annotation (port of
tapnet_tpu/utils/flow_track_assist.py).

Given dense optical flow and two clicks (a start and an end position), the
most flow-consistent trajectory between them comes from a dynamic program
whose cost of moving from source pixel q (frame t) to target pixel p
(frame t+1) is

    || q + flow_t[q] - p ||                for q within `radius` of p.

The forward pass runs on the device. The squared x and y parts of every
candidate's landing error depend on the source pixel and one offset
component only, so each frame first squares them once for the 2r+1 values
of each component. A frame's (2r+1)^2 window offsets are then taken a
block of offset rows at a time: the block's candidates are one
[rows, 2r+1, H, W] tensor, summed from strided views of those planes and
of the padded cost, and reduced with one `min` over the block (first index
on ties), so a frame at radius 20 takes a few dozen launches, not
thousands.
Blocks are folded into the running best with a strict `<`, in raster order:
the first offset of the smallest cost wins, as in the JAX loop. Each
operation is its own elementwise pass (no fused multiply-add), so the card
rounds the penalties as the CPU does. The backtrace (small, sequential,
data-dependent) runs on the host.

`chain_flow` is plain forward flow chaining on the host (numpy), for the
single-click case.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1e10
# The largest candidate block, in elements: a block of offset rows takes
# as many rows as fit (a few float32 temporaries of this size live at once).
_MAX_BLOCK_ELEMENTS = 1 << 26


def dp_step(cost: torch.Tensor, flow: torch.Tensor,
            radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """One frame of the forward DP.

  Args:
    cost: [H, W] float32 accumulated cost at frame t.
    flow: [H, W, 2] float32 flow (dx, dy) from frame t to t+1.
    radius: spatial search radius.

  Returns:
    (cost [H, W] at frame t+1, argmin [H, W] int32 flat window index of
    each pixel's best predecessor).
  """
  h, w = cost.shape
  window = 2 * radius + 1
  pad = (radius,) * 4
  costp = F.pad(cost[None, None], pad, value=_BIG)[0, 0].contiguous()
  flowp = F.pad(flow.permute(2, 0, 1)[None], pad)[0]
  hp, wp = costp.shape
  offsets = torch.arange(window, dtype=torch.float32,
                         device=cost.device) - radius
  # Offset d = q - p; predicted landing error = flow[q] + d. Its squared x
  # part depends on q and dx only, its y part on q and dy only: [window,
  # H + 2r, W + 2r] planes each, read below through strided views.
  sq_x = torch.square(flowp[0][None] + offsets[:, None, None]).contiguous()
  sq_y = torch.square(flowp[1][None] + offsets[:, None, None]).contiguous()
  plane = hp * wp
  rows = max(1, min(window, _MAX_BLOCK_ELEMENTS // (window * h * w)))
  best = torch.full((h, w), _BIG, dtype=torch.float32, device=cost.device)
  arg = torch.zeros((h, w), dtype=torch.int32, device=cost.device)
  for row0 in range(0, window, rows):
    n = min(rows, window - row0)
    size = (n, window, h, w)
    # Element (i, j, y, x): offset row row0 + i, column j, at pixel (y, x),
    # reading q = (row0 + i + y, j + x) of the padded planes.
    c = costp.as_strided(size, (wp, 1, wp, 1), row0 * wp)
    cand = torch.add(sq_x.as_strided(size, (wp, plane + 1, wp, 1), row0 * wp),
                     sq_y.as_strided(size, (plane + wp, 1, wp, 1),
                                     row0 * (plane + wp)))
    cand = torch.sqrt_(cand).add_(c)
    vals, idx = torch.min(cand.reshape(n * window, h, w), dim=0)
    take = vals < best
    best = torch.where(take, vals, best)
    arg = torch.where(take, (idx + row0 * window).to(torch.int32), arg)
  return best, arg


def _dp_forward(flows: torch.Tensor, init_cost: torch.Tensor, radius: int):
  """Runs the forward DP over all frames.

  Args:
    flows: [T, H, W, 2] dense flow, (dx, dy) from frame t to t+1.
    init_cost: [H, W] cost at the first frame (0 at the start click,
      large elsewhere).
    radius: spatial search radius per step.

  Returns:
    final_cost: [H, W] accumulated cost at the last frame.
    argmins: [T, H, W] int32 flat window index of each pixel's best
      predecessor, for host-side backtracking.
  """
  cost = init_cost.to(torch.float32)
  argmins = []
  for t in range(flows.shape[0]):
    cost, arg = dp_step(cost, flows[t].to(torch.float32), radius)
    argmins.append(arg)
  return cost, torch.stack(argmins)


def _clicks(start, end, h: int, w: int):
  clip = lambda v, hi: int(np.clip(round(v), 0, hi - 1))
  return (clip(start[0], w), clip(start[1], h)), (clip(end[0], w),
                                                  clip(end[1], h))


def backtrack(argmins: np.ndarray, end: Tuple[int, int],
              radius: int) -> np.ndarray:
  """[T+1, 2] float32 (x, y) positions from the argmins [T, H, W], ending
  at the (pixel) `end`."""
  t_steps, h, w = argmins.shape
  window = 2 * radius + 1
  track = np.zeros((t_steps + 1, 2), np.float32)
  track[-1] = end
  px, py = end
  for t in range(t_steps - 1, -1, -1):
    k = argmins[t, py, px]
    py = int(np.clip(py + k // window - radius, 0, h - 1))
    px = int(np.clip(px + k % window - radius, 0, w - 1))
    track[t] = (px, py)
  return track


def interpolate_track(
    flows: np.ndarray,
    start: Tuple[int, int],
    end: Tuple[int, int],
    radius: int = 20,
    device: Optional[Any] = None,
) -> np.ndarray:
  """Most flow-consistent trajectory between two annotated endpoints.

  Args:
    flows: [T-1, H, W, 2] dense optical flow in (dx, dy), frame t -> t+1.
    start: (x, y) pixel position at frame 0.
    end: (x, y) pixel position at frame T-1.
    radius: per-step search radius in pixels.
    device: torch device of the forward pass; None means "cuda" (raises
      without a card).

  Returns:
    [T, 2] float32 (x, y) positions, with track[0] == start and
    track[-1] == end.
  """
  from tapnet_tpu_torch.inference import resolve_device

  device = resolve_device(device)
  flows = np.asarray(flows, np.float32)
  h, w = flows.shape[1:3]
  (x0, y0), end = _clicks(start, end, h, w)
  init = torch.full((h, w), _BIG, dtype=torch.float32, device=device)
  init[y0, x0] = 0.0
  with torch.inference_mode():
    _, argmins = _dp_forward(torch.from_numpy(flows).to(device), init, radius)
  return backtrack(argmins.cpu().numpy(), end, radius)


def chain_flow(
    flows: np.ndarray, start: Tuple[float, float]
) -> np.ndarray:
  """Forward-chains a point through dense flow (no end constraint).

  Bilinearly samples the flow at the current (sub-pixel) position each
  step; drifts over long horizons — use `interpolate_track` when an end
  annotation exists.

  Args:
    flows: [T-1, H, W, 2] dense flow, (dx, dy).
    start: (x, y) position at frame 0.

  Returns:
    [T, 2] float32 (x, y) positions.
  """
  flows = np.asarray(flows, np.float32)
  t_steps, h, w = flows.shape[:3]
  pos = np.array(start, np.float32)
  out = [pos.copy()]
  for t in range(t_steps):
    x = np.clip(pos[0], 0, w - 1)
    y = np.clip(pos[1], 0, h - 1)
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
    fx, fy = x - x0, y - y0
    f = (
        flows[t, y0, x0] * (1 - fx) * (1 - fy)
        + flows[t, y0, x1] * fx * (1 - fy)
        + flows[t, y1, x0] * (1 - fx) * fy
        + flows[t, y1, x1] * fx * fy
    )
    pos = pos + f
    out.append(pos.copy())
  return np.stack(out)
