"""The one generator of traffic: videos, streams and query points made on
the device from `--seed`, by the parameters of a cell's `traffic` block.

Videos come from the benchmark's own copy of the port's synthetic renderer
(`tapnet_tpu_torch/data/synthetic.py`, copied so that the yardstick does not
move with the program): textured sprites that translate over a textured
background. Every seed gives the same sizes, counts and query layouts; only
the content and the positions differ.

Traffic parameters (a cell file's "traffic" object):

  pool           distinct videos (offline) or streams (online) made at set-up
  frames         frames of each video (offline) or of each stream's loop
  height, width  frame size
  sprites, velocity_px   the renderer's sprite count and largest speed
  queries        query points of a request (offline) or of each stream
  query_frames   "uniform": each query at a frame drawn over the clip;
                 "first": every query on frame 0
  query_layout   "random": positions drawn in the frame, `margin` px from
                 its edges; "grid": a `grid` x `grid` lattice of cell
                 centres moved by a draw within +-`jitter` px
  requests       query sets made at set-up: request i of the window takes
                 video i % pool and query set i % requests
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_TEX = 8


def _tent(coord: torch.Tensor) -> torch.Tensor:
  taps = torch.arange(_TEX, dtype=torch.float32, device=coord.device)
  return torch.clamp(
      1.0 - torch.abs(torch.clamp(coord, 0.0, 1.0)[..., None] * (_TEX - 1)
                      - taps), min=0.0)


def render(gen: torch.Generator, frames: int, height: int, width: int,
           sprites: int, velocity_px: float) -> torch.Tensor:
  """One clip [frames, H, W, 3] in [-1, 1] on the generator's device."""
  dev = gen.device
  uniform = lambda *shape: torch.rand(shape, generator=gen, device=dev)
  lo = torch.tensor([height * 0.2, width * 0.2], device=dev)
  hi = torch.tensor([height * 0.8, width * 0.8], device=dev)
  bg_small = uniform(_TEX, _TEX, 3)
  pos0 = uniform(sprites, 2) * (hi - lo) + lo
  vel = uniform(sprites, 2) * (2 * velocity_px) - velocity_px
  half = uniform(sprites, 1) * (height * 0.12) + height * 0.06
  tex_small = uniform(sprites, _TEX, _TEX, 3)
  bg = F.interpolate(bg_small.permute(2, 0, 1)[None], size=(height, width),
                     mode="bilinear", align_corners=False)
  out = bg[0].permute(1, 2, 0)[None].expand(frames, height, width, 3)
  ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
  xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
  ts = torch.arange(frames, dtype=torch.float32, device=dev)
  for s in range(sprites):
    center = pos0[s, None, :] + vel[s, None, :] * ts[:, None]  # [T, 2]
    hs = half[s, 0]
    dy = ys[None, :] - center[:, 0:1]  # [T, H]
    dx = xs[None, :] - center[:, 1:2]  # [T, W]
    inside = (torch.abs(dy) < hs)[:, :, None] & (torch.abs(dx) < hs)[:, None, :]
    wu = _tent(dy / (2 * hs) + 0.5)  # [T, H, 8]
    wv = _tent(dx / (2 * hs) + 0.5)  # [T, W, 8]
    tex = torch.einsum("thi,twj,ijc->thwc", wu, wv, tex_small[s])
    out = torch.where(inside[..., None], tex, out)
  return out * 2.0 - 1.0


def query_points(gen: torch.Generator, traffic: Dict, count: int
                 ) -> torch.Tensor:
  """[count, Q, 3] (t, y, x) raster query sets on the generator's device."""
  dev = gen.device
  q, t = traffic["queries"], traffic["frames"]
  h, w = traffic["height"], traffic["width"]
  if traffic["query_frames"] == "first":
    ts = torch.zeros(count, q, device=dev)
  else:
    ts = torch.randint(0, t, (count, q), generator=gen, device=dev).float()
  if traffic["query_layout"] == "grid":
    g = traffic["grid"]
    if g * g != q:
      raise ValueError(f"a {g} x {g} grid is not {q} queries")
    cy = (torch.arange(g, device=dev) + 0.5) * (h / g)
    cx = (torch.arange(g, device=dev) + 0.5) * (w / g)
    yy, xx = torch.meshgrid(cy, cx, indexing="ij")
    jitter = traffic["jitter"]
    move = (torch.rand(count, q, 2, generator=gen, device=dev) * 2 - 1) * jitter
    y = yy.reshape(1, q) + move[..., 0]
    x = xx.reshape(1, q) + move[..., 1]
  else:
    m = traffic["margin"]
    y = torch.rand(count, q, generator=gen, device=dev) * (h - 2 * m) + m
    x = torch.rand(count, q, generator=gen, device=dev) * (w - 2 * m) + m
  return torch.stack([ts, y, x], -1)


class Traffic:
  """What a window sends: a pool of clips [pool, T, H, W, 3] and
  `requests` query sets [requests, Q, 3], all made at set-up from one
  generator seeded with the run's seed."""

  def __init__(self, traffic: Dict, seed: int, device: torch.device):
    self.params = dict(traffic)
    gen = torch.Generator(device=device).manual_seed(seed)
    self.videos = torch.stack([
        render(gen, traffic["frames"], traffic["height"], traffic["width"],
               traffic["sprites"], traffic["velocity_px"])
        for _ in range(traffic["pool"])])
    self.queries = query_points(gen, traffic, traffic["requests"])

  def request(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Request i: ([1, T, H, W, 3] video, [1, Q, 3] query points)."""
    return (self.videos[i % len(self.videos)][None],
            self.queries[i % len(self.queries)][None])

  def streams(self) -> Tuple[torch.Tensor, torch.Tensor]:
    """The online streams: frames [S, T, H, W, 3] (a stream loops over its
    T frames) and each stream's queries [S, Q, 3]."""
    s = len(self.videos)
    return self.videos, self.queries[:s]
