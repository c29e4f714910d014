"""Dense many-point tracking with causal TAPIR, the RoboTAP front end (port
of tapnet_tpu/robotap/dense_tracking.py).

Samples many query points across the frames, extracts their query features
from their source frames (one backbone pass per distinct frame, scattered
into shared [1, N, C] banks in query order), then streams the whole video
once through causal TAPIR, all points in one query chunk, with the
`TapirCausalState` carried from frame to frame. The streamed outputs stay
on the device until the last frame.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.inference import resolve_device
from tapnet_tpu_torch.models import tapir as tapir_lib
from tapnet_tpu_torch.utils import sampling

Array = np.ndarray


def sample_grid_points(
    rng: np.random.RandomState,
    num_frames: int,
    height: int,
    width: int,
    num_points: int,
    query_frames: Optional[Sequence[int]] = None,
) -> Array:
  """Uniformly random (t, y, x) query points (t restricted to query_frames)."""
  if query_frames is None:
    ts = rng.randint(0, num_frames, num_points)
  else:
    ts = np.asarray(query_frames)[
        rng.randint(0, len(query_frames), num_points)
    ]
  ys = rng.rand(num_points) * height
  xs = rng.rand(num_points) * width
  return np.stack([ts, ys, xs], axis=-1).astype(np.float32)


def _query_feature_banks(model: tapir_lib.TAPIR, video: torch.Tensor,
                         query_points: Array) -> tapir_lib.QueryFeatures:
  """[1, N, C] query features, each taken from its own frame of `video`
  ([T, H, W, 3] on the model's device): one pass per distinct frame."""
  query_ts = query_points[:, 0].astype(np.int32)
  n = len(query_points)
  banks = None
  for frame_id in np.unique(query_ts):
    sel = np.nonzero(query_ts == frame_id)[0]
    pts = query_points[sel].copy()
    pts[:, 0] = 0.0  # relative to the single frame
    frame = video[None, frame_id:frame_id + 1]
    grids = model.get_feature_grids(frame)
    qf = model.get_query_features(
        frame.shape, torch.from_numpy(pts[None]).to(video.device), grids)
    if banks is None:
      zeros = lambda x: torch.zeros((x.shape[0], n) + tuple(x.shape[2:]),
                                    dtype=x.dtype, device=x.device)
      banks = ([zeros(x) for x in qf.lowres], [zeros(x) for x in qf.hires],
               qf.resolutions)
    idx = torch.from_numpy(sel).to(video.device)
    for bank, new in zip(banks[0] + banks[1], qf.lowres + qf.hires):
      bank[:, idx] = new
  return tapir_lib.QueryFeatures(tuple(banks[0]), tuple(banks[1]), banks[2])


def track_many_points(
    video: Array,
    params,
    config: Optional[tapir_lib.TapirConfig] = None,
    num_points: int = 1024,
    query_frames: Optional[Sequence[int]] = None,
    visibility_threshold: float = 0.5,
    seed: int = 0,
    device: Optional[Any] = None,
) -> Dict[str, Array]:
  """Densely track `num_points` random queries through a video.

  Args:
    video: [T, H, W, 3] uint8 or float; floats assumed already in [-1, 1].
    params: causal-TAPIR parameter tree in the Flax layout (numpy leaves).
    config: model config (must have use_causal_conv=True).
    num_points: number of random queries.
    query_frames: restrict query sampling to these frames (default: all).
    visibility_threshold: kept for the JAX signature; the flags are
      `sampling.postprocess_occlusions`' (probability 0.5), as there.
    seed: query sampling seed (np.random.RandomState, as in JAX).
    device: torch device; None means "cuda" (raises without a card).

  Returns:
    dict with tracks [N, T, 2] (x, y), visibility [N, T] (predictions before
    a point's query frame are masked invisible), query_points [N, 3],
    video_shape, and the logits behind the flags, occlusion and
    expected_dist [N, T] (which the JAX version does not return).
  """
  del visibility_threshold
  config = config or tapir_lib.causal_tapir_config()
  if not config.use_causal_conv:
    raise ValueError("track_many_points requires a causal config.")
  device = resolve_device(device)
  model = tapir_lib.TAPIR(config)
  load_flax_params(model, params)
  model = model.to(device).eval()

  if video.dtype == np.uint8:
    video_f = video.astype(np.float32) / 255.0 * 2.0 - 1.0
  else:
    video_f = np.asarray(video, np.float32)
  t, h, w = video_f.shape[:3]

  rng = np.random.RandomState(seed)
  query_points = sample_grid_points(rng, t, h, w, num_points, query_frames)
  query_ts = query_points[:, 0].astype(np.int32)

  with torch.inference_mode():
    frames = torch.from_numpy(video_f).to(device)
    query_features = _query_feature_banks(model, frames, query_points)

    state = model.construct_initial_causal_state(1, num_points, 1)
    p = config.num_pips_iter
    all_tracks, all_occ, all_expd = [], [], []
    for fr in range(t):
      frame = frames[None, fr:fr + 1]
      grids = model.get_feature_grids(frame)
      out = model.estimate_trajectories(
          (h, w), grids, query_features, None, None, state, True)
      state = out["causal_context"]
      # The last refinement iteration of each resolution, averaged.
      mean = lambda key: torch.stack(out[key][p::p]).mean(dim=0)[0, :, 0]
      all_tracks.append(mean("tracks"))
      all_occ.append(mean("occlusion"))
      all_expd.append(mean("expected_dist"))
    occlusion = torch.stack(all_occ, dim=1)  # [N, T]
    expected_dist = torch.stack(all_expd, dim=1)
    visibility = sampling.postprocess_occlusions(
        occlusion, expected_dist).cpu().numpy()
    tracks = torch.stack(all_tracks, dim=1).cpu().numpy()  # [N, T, 2]
    occlusion, expected_dist = occlusion.cpu().numpy(), expected_dist.cpu().numpy()
  # Predictions before a point's query frame are extrapolations; hide them.
  frame_ids = np.arange(t)[None, :]
  visibility = visibility & (frame_ids >= query_ts[:, None])

  return {
      "tracks": tracks,
      "visibility": visibility,
      "query_points": query_points,
      "video_shape": np.array(video_f.shape),
      "occlusion": occlusion,
      "expected_dist": expected_dist,
  }
