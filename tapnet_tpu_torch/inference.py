"""User-facing TAPIR inference (port of tapnet_tpu/inference.py::TapirPredictor).

`TapirPredictor` binds a Flax-layout parameter tree to the port's TAPIR and
tracks points on the CUDA card by default. Query counts (and optionally frame
counts) are padded up to buckets, as in the JAX version, so results do not
depend on how a request was cut. Without a card, it raises unless the caller
asked for `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.models import tapir as tapir_lib
from tapnet_tpu_torch.utils import sampling


def _round_up(x: int, multiple: int) -> int:
  return -(-x // multiple) * multiple


def resolve_device(device: Optional[Any] = None) -> torch.device:
  """The entry points' device rule: None means the CUDA card; a CUDA device
  without a card raises rather than falling back to the CPU."""
  device = torch.device("cuda" if device is None else device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "No CUDA device is available; pass device='cpu' to run on the CPU."
    )
  return device


class TapirPredictor:
  """Binds TAPIR params and exposes shape-bucketed tracking."""

  def __init__(
      self,
      params: Mapping[str, Any],
      config: Optional[tapir_lib.TapirConfig] = None,
      query_bucket: int = 64,
      frame_bucket: Optional[int] = None,
      query_chunk_size: Optional[int] = 64,
      bfloat16: bool = False,
      refinement_resolutions: Optional[Sequence[Tuple[int, int]]] = None,
      device: Optional[Any] = None,
  ):
    """Args:
      params: Flax-layout parameter tree with numpy leaves (e.g. from
        `checkpoints.tapir_checkpoint.load_tapir_checkpoint`).
      config: model configuration.
      query_bucket: queries are padded up to a multiple of this.
      frame_bucket: if set, frames are padded (by repeating the last frame)
        up to a multiple of this. The mixer is temporal and bidirectional, so
        a padded tail can shift predictions slightly.
      query_chunk_size: memory-bounding chunk inside the model.
      bfloat16: run backbone / correlations / mixer in bf16 (float32
        accumulations and heads); float32 parameters are cast to bf16.
      refinement_resolutions: override the refinement resolution ladder
        (default: log-spaced from the initial resolution up to the video's).
      device: torch device; None means "cuda" (raises without a card).
    """
    self.device = resolve_device(device)
    config = config or tapir_lib.TapirConfig()
    if bfloat16:
      config = dataclasses.replace(config, compute_dtype="bfloat16")
    model = tapir_lib.TAPIR(config)
    load_flax_params(model, params)
    if bfloat16:
      model = model.to(torch.bfloat16)
    self.model = model.to(self.device).eval()
    self.query_bucket = query_bucket
    self.frame_bucket = frame_bucket
    self.query_chunk_size = query_chunk_size
    self.refinement_resolutions = (
        None
        if refinement_resolutions is None
        else [tuple(r) for r in refinement_resolutions]
    )

  def _dispatch(self, video, query_points):
    """Pads to the buckets and enqueues the forward pass on the device."""
    video = torch.as_tensor(video).to(self.device)
    query_points = torch.as_tensor(query_points, dtype=torch.float32).to(
        self.device
    )
    b, n = query_points.shape[:2]
    t = video.shape[1]
    n_pad = _round_up(max(n, 1), self.query_bucket)
    if n_pad != n:
      pad = query_points.new_zeros((b, n_pad - n, 3))
      query_points = torch.cat([query_points, pad], dim=1)
    if self.frame_bucket is not None:
      t_pad = _round_up(t, self.frame_bucket)
      if t_pad != t:
        tail = video[:, -1:].expand(-1, t_pad - t, -1, -1, -1)
        video = torch.cat([video, tail], dim=1)
    chunk = min(self.query_chunk_size or n_pad, n_pad)
    with torch.inference_mode():
      out = self.model(
          video,
          query_points,
          query_chunk_size=chunk,
          refinement_resolutions=self.refinement_resolutions,
      )
    return out, n, t

  @staticmethod
  def _materialize(out, n, t) -> Mapping[str, np.ndarray]:
    return {
        key: out[key][:, :n, :t].float().cpu().numpy()
        for key in ("tracks", "occlusion", "expected_dist")
    }

  def __call__(self, video, query_points) -> Mapping[str, np.ndarray]:
    """Tracks `query_points` ([B, N, 3] (t, y, x) raster) through `video`
    ([B, T, H, W, 3] floats in [-1, 1]).

    Returns numpy arrays: tracks [B, N, T, 2] (x, y), occlusion /
    expected_dist logits [B, N, T].
    """
    return self._materialize(*self._dispatch(video, query_points))

  def visibles(self, out: Mapping[str, np.ndarray]) -> np.ndarray:
    """Boolean visibility from occlusion + uncertainty logits."""
    return sampling.postprocess_occlusions(
        torch.from_numpy(np.asarray(out["occlusion"])),
        torch.from_numpy(np.asarray(out["expected_dist"])),
    ).numpy()

  def track_many(
      self, inputs: Iterable[Tuple[Any, Any]]
  ) -> Iterator[Mapping[str, np.ndarray]]:
    """Yields one result dict per (video, query_points) item, in order.

    Results are copied to the host one item behind the dispatch: the device
    runs item i's kernels while the host prepares and enqueues item i+1.
    """
    pending = None
    for video, query_points in inputs:
      dispatched = self._dispatch(video, query_points)
      if pending is not None:
        yield self._materialize(*pending)
      pending = dispatched
    if pending is not None:
      yield self._materialize(*pending)
