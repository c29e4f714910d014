"""User-facing inference (port of tapnet_tpu/inference.py: TapirPredictor,
OnlineTapirPredictor, TapnextPredictor, OnlineTapnextPredictor).

Each predictor binds a Flax-layout parameter tree to the port's model and
tracks points on the CUDA card by default. Without a card, it raises unless
the caller asked for `device="cpu"`.

  * `TapirPredictor` pads query counts (and optionally frame counts) up to
    buckets, as in the JAX version, so results do not depend on how a
    request was cut. With a `mesh` it runs over ranks: the backbone on each
    rank's frames, the feature grids all-gathered, the refinement on each
    rank's queries, and the outputs gathered on every rank.
  * `OnlineTapirPredictor` runs causal TAPIR one frame at a time, with the
    mixers' streaming state carried from step to step.
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
from tapnet_tpu_torch.parallel import mesh as mesh_lib
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
      mesh: Optional[mesh_lib.Mesh] = None,
  ):
    """Args:
      params: Flax-layout parameter tree with numpy leaves (e.g. from
        `checkpoints.tapir_checkpoint.load_tapir_checkpoint`); the same on
        every rank of a `mesh`.
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
      device: torch device; None means "cuda" (raises without a card); with
        a `mesh`, rank r takes cuda:{r % cards}.
      mesh: a `parallel.mesh.Mesh` for multi-device inference, as the JAX
        predictor's (`mesh_lib.inference_shardings`): frames are split over
        the ranks for the backbone, the feature grids all-gathered, queries
        split for the refinement, and every rank returns the whole outputs.
        Queries and frames are padded up to multiples of the rank count (the
        frames by repeating the last one, as `frame_bucket`).
    """
    device = resolve_device(device) if mesh is None else mesh.device(device)
    config = config or tapir_lib.TapirConfig()
    if bfloat16:
      config = dataclasses.replace(config, compute_dtype="bfloat16")
    model = tapir_lib.TAPIR(config)
    load_flax_params(model, params)
    if bfloat16:
      model = model.to(torch.bfloat16)
    if mesh is not None:
      ranks = mesh.size()
      query_bucket = _round_up(query_bucket, ranks)
      frame_bucket = _round_up(frame_bucket or 1, ranks)
    self._bind(model.to(device).eval(), device, query_bucket, frame_bucket,
               query_chunk_size, refinement_resolutions, mesh)

  @classmethod
  def from_model(cls, model: tapir_lib.TAPIR,
                 query_chunk_size: Optional[int] = 64) -> "TapirPredictor":
    """A predictor over `model`'s own weights, on its device, with no copy
    (in-train evaluation), and the default buckets and resolutions. The
    caller sets the module's mode."""
    self = cls.__new__(cls)
    self._bind(model, next(model.parameters()).device, 64, None,
               query_chunk_size, None)
    return self

  def _bind(self, model, device, query_bucket, frame_bucket,
            query_chunk_size, refinement_resolutions, mesh=None):
    self.model = model
    self.mesh = mesh
    self.device = device
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
      if self.mesh is None:
        out = self.model(
            video,
            query_points,
            query_chunk_size=chunk,
            refinement_resolutions=self.refinement_resolutions,
        )
      else:
        out = self._sharded_forward(video, query_points, chunk)
    return out, n, t

  def _sharded_forward(self, video, query_points, chunk):
    """The forward over the mesh's ranks (`mesh_lib.inference_shardings`):
    the same function as one rank's, up to float sums in other orders."""
    mesh = self.mesh
    frames, queries, outputs = mesh_lib.inference_shardings(mesh)
    local = self.model.get_feature_grids(
        mesh_lib.shard(video, mesh, *frames), self.refinement_resolutions)
    gathered = {}

    def whole(grid):  # a grid shared by two levels is gathered once
      if id(grid) not in gathered:
        gathered[id(grid)] = mesh_lib.gather(grid, mesh, frames[0], dim=1)
      return gathered[id(grid)]

    grids = tapir_lib.FeatureGrids(
        tuple(whole(g) for g in local.lowres),
        tuple(whole(g) for g in local.hires), local.resolutions)
    mine = mesh_lib.shard(query_points, mesh, *queries)
    out = self.model(video, mine, query_chunk_size=min(chunk, mine.shape[1]),
                     refinement_resolutions=self.refinement_resolutions,
                     feature_grids=grids)
    return {key: mesh_lib.gather(out[key], mesh, *outputs)
            for key in ("tracks", "occlusion", "expected_dist")}

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


class OnlineTapirPredictor:
  """Streaming TAPIR: per-frame tracking with typed causal state.

    p = OnlineTapirPredictor(params, tapir.causal_bootstapir_config())
    p.init(first_frame, query_points)       # query features + zero state
    for frame in frames:
      tracks, visibles = p.predict(frame)

  The parameters keep their dtype, as the JAX predictor's do, and the
  configuration's `compute_dtype` sets the casts (float32 or bfloat16). The
  streaming state is float32. Only one refinement resolution is streamed:
  frames at the initial resolution, or `num_resolutions` of the state
  would have to grow (as in JAX).

  The int8 modes stream as JAX's do, each step on its one frame: the
  correlation grids are quantized anew every step (`estimate_trajectories`
  quantizes the step's grids, per frame for K2, per position for K2b), the
  per-frame int8 ExtraConvs (X) take the frame's own activation scale, and
  the w8a8 mixer runs its channel MLP as `mixer_math.mlp_math_q8` beside
  the cache. The per-pixel ExtraConvs kernel (K6) never fires on one frame
  (`fused_extra_convs.wants_fused` needs 4 * 1024 * 1024 elements), so
  `quantized_extra_convs="per_pixel"` streams the per-frame scheme, as in
  JAX.
  """

  def __init__(
      self,
      params: Mapping[str, Any],
      config: Optional[tapir_lib.TapirConfig] = None,
      device: Optional[Any] = None,
  ):
    """Args:
      params: Flax-layout TAPIR parameter tree with numpy leaves.
      config: a causal configuration (`use_causal_conv=True`), by default
        `TapirConfig(use_causal_conv=True, num_pips_iter=4,
        pyramid_level=1)`.
      device: torch device; None means "cuda" (raises without a card).
    """
    config = config or tapir_lib.TapirConfig(
        use_causal_conv=True, num_pips_iter=4, pyramid_level=1)
    if not config.use_causal_conv:
      raise ValueError("Online TAPIR requires use_causal_conv=True.")
    self.device = resolve_device(device)
    model = tapir_lib.TAPIR(config)
    load_flax_params(model, params)
    self.model = model.to(self.device).eval()
    self._query_features = None
    self._state = None

  def _frame(self, frame) -> torch.Tensor:
    frame = torch.as_tensor(frame, dtype=torch.float32).to(self.device)
    return frame[:, None] if frame.ndim == 4 else frame

  def _query_features_of(self, frame, query_points):
    query_points = torch.as_tensor(query_points, dtype=torch.float32).to(
        self.device)
    grids = self.model.get_feature_grids(frame)
    return self.model.get_query_features(frame.shape, query_points, grids)

  def init(self, frame, query_points) -> None:
    """Query features from `frame` ([B, H, W, 3] or [B, 1, H, W, 3], in
    [-1, 1]) at `query_points` ([B, N, 3] (t, y, x), t = 0), and a zero
    state."""
    frame = self._frame(frame)
    b, n = np.shape(query_points)[:2]
    with torch.inference_mode():
      self._query_features = self._query_features_of(frame, query_points)
      self._state = self.model.construct_initial_causal_state(b, n, 1)

  def step(self, frame) -> Mapping[str, np.ndarray]:
    """One streaming step on `frame` ([B, H, W, 3] in [-1, 1]): tracks
    [B, N, 2] (x, y), visibles [B, N], and the occlusion and expected_dist
    logits [B, N] (the mean over the last iteration of each resolution), as
    numpy arrays."""
    if self._query_features is None:
      raise ValueError("Call init() before predict().")
    frame = self._frame(frame)
    cfg = self.model.config
    with torch.inference_mode():
      grids = self.model.get_feature_grids(frame)
      out = self.model.estimate_trajectories(
          tuple(frame.shape[-3:-1]), grids, self._query_features, None, None,
          self._state, True)
      self._state = out["causal_context"]
      p = cfg.num_pips_iter
      mean = lambda key: torch.stack(out[key][p::p]).mean(dim=0)[:, :, 0]
      tracks, occ, expd = mean("tracks"), mean("occlusion"), mean("expected_dist")
      visibles = sampling.postprocess_occlusions(occ, expd)
    return dict(tracks=tracks.cpu().numpy(), visibles=visibles.cpu().numpy(),
                occlusion=occ.cpu().numpy(), expected_dist=expd.cpu().numpy())

  def predict(self, frame) -> Tuple[np.ndarray, np.ndarray]:
    """One streaming step: (tracks [B, N, 2] (x, y), visibles [B, N])."""
    out = self.step(frame)
    return out["tracks"], out["visibles"]

  def add_points(self, frame, query_points, idx: Sequence[int]) -> None:
    """Replaces the tracked slots `idx` with new query points on `frame`
    (t = 0), each with a fresh state."""
    frame = self._frame(frame)
    b = np.shape(query_points)[0]
    with torch.inference_mode():
      new_qf = self._query_features_of(frame, query_points)
      fresh = self.model.construct_initial_causal_state(b, len(idx), 1)
      self._query_features, self._state = tapir_lib.update_query_features(
          self._query_features, new_qf, idx, self._state, fresh)


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
      mesh: Optional[mesh_lib.Mesh] = None,
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
      device: torch device; None means "cuda" (raises without a card); with
        a `mesh`, rank r takes cuda:{r % cards}.
      mesh: a `parallel.mesh.Mesh`: each clip (or chunk) runs time-split over
        its "data" axis (sequence parallelism, `models/ssm_vit.py`), and every
        rank returns the whole outputs. The frame count (and `chunk_size`)
        must be a multiple of the axis size.
    """
    device = resolve_device(device) if mesh is None else mesh.device(device)
    config = config or ssm_vit.SsmVitConfig()
    if mesh is not None:
      config = dataclasses.replace(config, sp_mesh=mesh,
                                   sp_axis=mesh_lib.DATA_AXIS)
    self._bind(_tapnext_model(params, config, device), device, query_bucket,
               chunk_size)

  @classmethod
  def from_model(cls, model: tapnext.TAPNextTracker) -> "TapnextPredictor":
    """A predictor over `model`'s own weights, on its device, with no copy
    (in-train evaluation): one pass, no query bucket. The caller sets the
    module's mode."""
    self = cls.__new__(cls)
    self._bind(model, next(model.parameters()).device, None, None)
    return self

  def _bind(self, model, device, query_bucket, chunk_size):
    self.model = model
    self.device = device
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

  def step(self, frame):
    """One frame [B, H, W, 3] (or [B, 1, H, W, 3]) -> ((y, x) tracks
    [B, Q, 2], visibility logits [B, Q]) as numpy arrays."""
    if self._state is None:
      raise ValueError("Call init() first.")
    frame = torch.as_tensor(frame, dtype=torch.float32).to(self.device)
    if frame.ndim == 4:
      frame = frame[:, None]
    with torch.inference_mode():
      res = self.model.forward_step(frame, state=self._state)
    self._state = res.state
    return (res.tracks[:, :, 0].cpu().numpy(),
            res.visible_logits[:, :, 0, 0].cpu().numpy())

  def predict(self, frame):
    """One frame [B, H, W, 3] (or [B, 1, H, W, 3]) -> ((y, x) tracks
    [B, Q, 2], boolean visibility [B, Q]) as numpy arrays."""
    tracks, logits = self.step(frame)
    return tracks, logits > 0
