"""Synthetic point-tracking data, made on the device (port of
tapnet_tpu/data/synthetic.py: `make_batch`, `batch_iterator`, `export_npz`).

Textured sprites translate over a textured background; query points ride
the sprites, occluded where a point leaves the frame or a later-drawn
sprite covers it. The random draws (`draw`) are kept apart from the
renderer (`render_batch`), which is deterministic: the JAX package draws
with its own random generator, the port with a `torch.Generator`, so the
two give other batches from one seed, and a test feeds the JAX package's
draws to `render_batch` to hold it to the JAX `make_batch`.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

Batch = Dict[str, torch.Tensor]

_TEX = 8  # background and texture resolution

# The held-out sets behind the BootsTAPIR accuracy numbers, as `export_npz`'s
# arguments (16 videos each, 24 frames at 256^2, 64 tracks): "a" at its
# defaults, "b" out of domain (twice the sprites, faster). The JAX package's
# draws of both are committed (tests/data/synth_eval_draws.npz, written by
# tools/make_eval_draws.py); `load_draws` reads them for
# `export_npz(draws=...)`, which rebuilds JAX's exact videos. They are scored
# with strided queries through `TapirPredictor(query_chunk_size=32)`.
HELD_OUT_SETS = {
    "a": dict(num_examples=16, seed=10_000, num_frames=24, height=256,
              width=256, num_queries=64, num_sprites=6, vel_range=3.0),
    "b": dict(num_examples=16, seed=20_000, num_frames=24, height=256,
              width=256, num_queries=64, num_sprites=12, vel_range=7.0),
}
HELD_OUT_QUERY_MODE = "strided"
HELD_OUT_QUERY_CHUNK_SIZE = 32
DRAW_KEYS = ("bg_small", "pos0", "vel", "half", "tex_small", "sprite_id",
             "offset", "t_query")


def load_draws(path: str, name: str) -> Dict[str, np.ndarray]:
  """{draw name: array with a leading video axis} of held-out set `name`
  from the npz at `path` (`<set>/<draw name>` arrays)."""
  with np.load(path) as z:
    return {k: z[f"{name}/{k}"] for k in DRAW_KEYS}


def draw(generator: torch.Generator, batch_size: int = 1,
         num_frames: int = 8, height: int = 256, width: int = 256,
         num_queries: int = 32, num_sprites: int = 6,
         vel_range: float = 3.0) -> Batch:
  """The random values of one batch, on the generator's device, as the JAX
  package draws them per example: the background and sprite textures
  (uniform in [0, 1)), sprite centres at t = 0 (within the middle 60% of
  the frame), velocities (px/frame), half-sizes, and per query its sprite,
  its offset in units of the sprite's half-size (in [-0.9, 0.9)) and its
  query frame."""
  dev = generator.device
  b, s, q = batch_size, num_sprites, num_queries
  uniform = lambda *shape: torch.rand(shape, generator=generator, device=dev)
  lo = torch.tensor([height * 0.2, width * 0.2], device=dev)
  hi = torch.tensor([height * 0.8, width * 0.8], device=dev)
  return {
      "bg_small": uniform(b, _TEX, _TEX, 3),
      "pos0": uniform(b, s, 2) * (hi - lo) + lo,
      "vel": uniform(b, s, 2) * (2 * vel_range) - vel_range,
      "half": uniform(b, s, 1) * (height * 0.18 - height * 0.06) + height * 0.06,
      "tex_small": uniform(b, s, _TEX, _TEX, 3),
      "sprite_id": torch.randint(0, s, (b, q), generator=generator, device=dev),
      "offset": uniform(b, q, 2) * 1.8 - 0.9,
      "t_query": torch.randint(0, num_frames, (b, q), generator=generator,
                               device=dev),
  }


def _tent(coord: torch.Tensor) -> torch.Tensor:
  """Tent weights of a sprite-local coordinate in [0, 1] over the texture's
  rows or columns: [..., _TEX]."""
  taps = torch.arange(_TEX, dtype=torch.float32, device=coord.device)
  return torch.clamp(
      1.0 - torch.abs(torch.clamp(coord, 0.0, 1.0)[..., None] * (_TEX - 1)
                      - taps), min=0.0)


def render_batch(draws: Batch, num_frames: int, height: int,
                 width: int) -> Batch:
  """{video [B, T, H, W, 3] in [-1, 1], query_points [B, Q, 3] (t, y, x),
  target_points [B, Q, T, 2] (x, y), occluded [B, Q, T] float} from
  `draw`'s values. The background is the bilinear upsampling of its small
  texture; each sprite's texture is sampled bilinearly in sprite-local
  coordinates, so it translates rigidly with the sprite."""
  bg_small, pos0, vel, half = (draws[k] for k in ("bg_small", "pos0", "vel",
                                                   "half"))
  dev = pos0.device
  b, num_sprites = pos0.shape[:2]
  bg = F.interpolate(bg_small.permute(0, 3, 1, 2), size=(height, width),
                     mode="bilinear", align_corners=False)
  frames = bg.permute(0, 2, 3, 1)[:, None].expand(
      b, num_frames, height, width, 3)
  depth = torch.full((b, num_frames, height, width), -1, dtype=torch.long,
                     device=dev)
  ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
  xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
  ts = torch.arange(num_frames, dtype=torch.float32, device=dev)
  for s in range(num_sprites):
    center = pos0[:, s, None, :] + vel[:, s, None, :] * ts[None, :, None]
    hs = half[:, s, 0][:, None, None]  # [B, 1, 1]
    dy = ys[None, None, :] - center[..., 0:1]  # [B, T, H]
    dx = xs[None, None, :] - center[..., 1:2]  # [B, T, W]
    inside = ((torch.abs(dy) < hs)[..., :, None]
              & (torch.abs(dx) < hs)[..., None, :])
    wu = _tent(dy / (2 * hs) + 0.5)  # [B, T, H, 8]
    wv = _tent(dx / (2 * hs) + 0.5)  # [B, T, W, 8]
    tex = torch.einsum("bthi,btwj,bijc->bthwc", wu, wv,
                       draws["tex_small"][:, s])
    frames = torch.where(inside[..., None], tex, frames)
    depth = torch.where(inside, s, depth)

  sprite_id = draws["sprite_id"]
  t_query = draws["t_query"]
  bidx = torch.arange(b, device=dev)[:, None]
  offset = draws["offset"] * half[bidx, sprite_id]  # [B, Q, 2]
  track_yx = (pos0[bidx, sprite_id][:, :, None, :]
              + vel[bidx, sprite_id][:, :, None, :] * ts[None, None, :, None]
              + offset[:, :, None, :])  # [B, Q, T, 2]
  ty, tx = track_yx[..., 0], track_yx[..., 1]
  in_frame = (ty > 0) & (ty < height) & (tx > 0) & (tx < width)
  # Truncation toward zero, then clipping, as astype(int32) and jnp.clip.
  iy = torch.clamp(ty.to(torch.int32), 0, height - 1).long()
  ix = torch.clamp(tx.to(torch.int32), 0, width - 1).long()
  tidx = torch.arange(num_frames, device=dev)[None, None, :]
  depth_at = depth[bidx[..., None], tidx, iy, ix]  # [B, Q, T]
  occluded = (~in_frame) | (depth_at > sprite_id[..., None])

  query_yx = torch.gather(
      track_yx, 2, t_query[:, :, None, None].expand(-1, -1, 1, 2))[:, :, 0]
  query_points = torch.cat([t_query[..., None].float(), query_yx], dim=-1)
  return {
      "video": frames * 2.0 - 1.0,
      "query_points": query_points,
      "target_points": track_yx.flip(-1),
      "occluded": occluded.float(),
  }


def make_batch(generator: torch.Generator, batch_size: int = 1,
               num_frames: int = 8, height: int = 256, width: int = 256,
               num_queries: int = 32, num_sprites: int = 6,
               vel_range: float = 3.0) -> Batch:
  """One batch {video, query_points, target_points, occluded} on the
  generator's device. `num_sprites` and `vel_range` (max px/frame) shift the
  data distribution."""
  draws = draw(generator, batch_size, num_frames, height, width, num_queries,
               num_sprites, vel_range)
  return render_batch(draws, num_frames, height, width)


def export_npz(out_dir: str, num_examples: int, seed: int = 10_000,
               num_frames: int = 24, height: int = 256, width: int = 256,
               num_queries: int = 64, num_sprites: int = 6,
               vel_range: float = 3.0,
               draws: Optional[Mapping[str, np.ndarray]] = None) -> None:
  """Writes a fixed synthetic dataset in the Kubric npz layout
  (`synth_{i:04d}.npz`: video uint8 [T, H, W, 3], target_points [N, T, 2]
  (x, y) raster, occluded [N, T] bool), which `tapvid.datasets.
  create_kubric_dataset` reads: the counterpart of the JAX package's
  `export_npz`, rendered on the CPU.

  The draws come from a `torch.Generator` seeded with `seed`, or, given
  `draws` ({draw name: array with a leading video axis}, e.g.
  `load_draws`), from those: the JAX package's own
  draws rebuild its held-out sets. The uint8 conversion is JAX's,
  `clip((v + 1) * 127.5, 0, 255)` truncated toward zero.
  """
  os.makedirs(out_dir, exist_ok=True)
  generator = torch.Generator().manual_seed(seed)
  for i in range(num_examples):
    if draws is None:
      one = draw(generator, 1, num_frames, height, width, num_queries,
                 num_sprites, vel_range)
    else:
      one = {k: torch.from_numpy(np.asarray(v[i : i + 1])) for k, v in
             draws.items()}
      one["sprite_id"] = one["sprite_id"].long()
      one["t_query"] = one["t_query"].long()
    batch = render_batch(one, num_frames, height, width)
    video = batch["video"][0].numpy()
    np.savez(
        os.path.join(out_dir, f"synth_{i:04d}.npz"),
        video=np.clip((video + 1.0) * 127.5, 0, 255).astype(np.uint8),
        target_points=batch["target_points"][0].numpy(),
        occluded=batch["occluded"][0].numpy().astype(bool),
    )


def batch_iterator(seed: int = 0, device: Optional[torch.device] = None,
                   **kwargs) -> Iterator[Batch]:
  """Infinite generator of batches made on `device` (the CUDA card if None)
  from one generator seeded with `seed`."""
  generator = torch.Generator(device=device or "cuda").manual_seed(seed)
  while True:
    yield make_batch(generator, **kwargs)
