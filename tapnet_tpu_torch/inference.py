"""User-facing inference (port of tapnet_tpu/inference.py: TapirPredictor,
TapnextPredictor, OnlineTapnextPredictor).

Each predictor binds a Flax-layout parameter tree to the port's model and
tracks points on the CUDA card by default. Without a card, it raises unless
the caller asked for `device="cpu"`.

  * `TapirPredictor` pads query counts (and optionally frame counts) up to
    buckets, as in the JAX version, so results do not depend on how a
    request was cut.
  * `TapnextPredictor` runs TAPNext offline, in time chunks with the SSM
    state carried from one to the next when `chunk_size` is set.
  * `OnlineTapnextPredictor` runs TAPNext one frame at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints.convert import load_flax_params, load_tapnext_params
from tapnet_tpu_torch.models import ssm_vit, tapnext
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


def _tapnext_model(params, config, device) -> tapnext.TAPNextTracker:
  model = tapnext.TAPNextTracker(config or ssm_vit.SsmVitConfig())
  load_tapnext_params(model, params)
  return model.to(device).eval()


class TapnextPredictor:
  """TAPNext inference with the TAP-Vid calling convention.

  TAP-Vid queries are (t, y, x) with tracks (x, y); TAPNext consumes
  (t, y, x) and emits (y, x), so only the output axis order flips. Occlusion
  logits are negated visibility logits; there is no expected_dist.

  TAPNext's query tokens attend to each other and to the image tokens, so
  padding the query axis changes predictions: bucketing is off by default.
  """

  def __init__(
      self,
      params: Mapping[str, Any],
      config: Optional[ssm_vit.SsmVitConfig] = None,
      query_bucket: Optional[int] = None,
      chunk_size: Optional[int] = None,
      device: Optional[Any] = None,
  ):
    """Args:
      params: Flax-layout TAPNext parameter tree with numpy leaves (e.g. from
        `checkpoints.tapnext_checkpoint.load_tapnext_checkpoint`).
      config: model configuration (default: ViT-B at 256x256).
      query_bucket: if set, queries are padded up to a multiple of this.
      chunk_size: if set, videos longer than this run in time chunks with
        the recurrent state carried across chunks (the same result as one
        pass: the temporal mixer is exactly recurrent and attention is per
        frame), bounding activation memory by the chunk. The last chunk is
        padded by repeating the last frame.
      device: torch device; None means "cuda" (raises without a card).
    """
    self.device = resolve_device(device)
    self.model = _tapnext_model(params, config, self.device)
    self.query_bucket = query_bucket
    self.chunk_size = chunk_size

  def _forward_chunked(self, video, query_points):
    """Time-chunked forward with the recurrent state carried; returns the
    same (tracks, visible_logits) as one pass."""
    c = self.chunk_size
    t = video.shape[1]
    pad_t = -t % c
    if pad_t:
      tail = video[:, -1:].expand(-1, pad_t, -1, -1, -1)
      video = torch.cat([video, tail], dim=1)
    res = self.model.forward_step(video[:, :c], query_points)
    tracks_all, vis_all, state = [res.tracks], [res.visible_logits], res.state
    for start in range(c, video.shape[1], c):
      res = self.model.forward_step(video[:, start:start + c], state=state)
      tracks_all.append(res.tracks)
      vis_all.append(res.visible_logits)
      state = res.state
    # Chunks come back [B, Q, T_c, ...]: concatenate over time, drop the pad.
    tracks = torch.cat(tracks_all, dim=2)[:, :, :t]
    vis = torch.cat(vis_all, dim=2)[:, :, :t]
    return tracks, vis

  def __call__(self, video, query_points) -> Mapping[str, Any]:
    """Tracks `query_points` ([B, N, 3] (t, y, x) raster) through `video`
    ([B, T, H, W, 3] floats in [-1, 1]).

    Returns tracks [B, N, T, 2] (x, y) and occlusion logits [B, N, T] as
    numpy arrays, and expected_dist None.
    """
    video = torch.as_tensor(video, dtype=torch.float32).to(self.device)
    query_points = torch.as_tensor(query_points, dtype=torch.float32).to(
        self.device)
    b, n = query_points.shape[:2]
    if self.query_bucket is not None:
      n_pad = _round_up(max(n, 1), self.query_bucket)
      if n_pad != n:
        pad = query_points.new_zeros((b, n_pad - n, 3))
        query_points = torch.cat([query_points, pad], dim=1)
    with torch.inference_mode():
      if self.chunk_size is not None and video.shape[1] > self.chunk_size:
        tracks_yx, visible_logits = self._forward_chunked(video, query_points)
      else:
        out = self.model(video, query_points, intermediates=False)
        tracks_yx, visible_logits = out.tracks, out.visible_logits
    return {
        "tracks": tracks_yx[:, :n].flip(-1).cpu().numpy(),
        "occlusion": (-visible_logits[:, :n, :, 0]).cpu().numpy(),
        "expected_dist": None,
    }


class OnlineTapnextPredictor:
  """Streaming TAPNext: a warm-up on the first frame(s) with the queries,
  then one step per frame with the recurrent state carried."""

  def __init__(self, params: Mapping[str, Any],
               config: Optional[ssm_vit.SsmVitConfig] = None,
               device: Optional[Any] = None):
    self.device = resolve_device(device)
    self.model = _tapnext_model(params, config, self.device)
    self._state = None

  def init(self, frames, query_points):
    """frames [B, T0, H, W, 3]; query_points [B, Q, 3] (t, y, x). Returns
    ((y, x) tracks [B, Q, T0, 2], visibility logits [B, Q, T0, 1]) as
    numpy arrays."""
    frames = torch.as_tensor(frames, dtype=torch.float32).to(self.device)
    query_points = torch.as_tensor(query_points, dtype=torch.float32).to(
        self.device)
    with torch.inference_mode():
      res = self.model.forward_step(frames, query_points)
    self._state = res.state
    return res.tracks.cpu().numpy(), res.visible_logits.cpu().numpy()

  def predict(self, frame):
    """One frame [B, H, W, 3] (or [B, 1, H, W, 3]) -> ((y, x) tracks
    [B, Q, 2], boolean visibility [B, Q]) as numpy arrays."""
    if self._state is None:
      raise ValueError("Call init() first.")
    frame = torch.as_tensor(frame, dtype=torch.float32).to(self.device)
    if frame.ndim == 4:
      frame = frame[:, None]
    with torch.inference_mode():
      res = self.model.forward_step(frame, state=self._state)
    self._state = res.state
    return (res.tracks[:, :, 0].cpu().numpy(),
            (res.visible_logits[:, :, 0, 0] > 0).cpu().numpy())
