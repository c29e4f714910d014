"""TAPNext tracker: ViT-SSM backbone + quantized-coordinate heads (port of
tapnet_tpu/models/tapnext.py, inference).

Coordinates are 512 logits split into two 256-bin axes, decoded by a
truncated soft-argmax (threshold 20 bins, temperature 0.5, +0.5 raster
offset), in float32 whatever the backbone's compute dtype. Query points are
(t, y, x); output tracks are (y, x) in model raster coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
from torch import nn

from tapnet_tpu_torch.models import ssm_vit
from tapnet_tpu_torch.models.layers import linear
from tapnet_tpu_torch.ops.mixer_math import gelu


@dataclasses.dataclass
class TrackerResults:
  tracks: torch.Tensor  # [B, Q, T, 2] (y, x)
  track_logits: torch.Tensor  # [B, Q, T, 512]
  visible_logits: torch.Tensor  # [B, Q, T, 1]
  intermediate_tracks: List[torch.Tensor]
  intermediate_track_logits: List[torch.Tensor]
  intermediate_visible_logits: List[torch.Tensor]
  state: Optional[Any] = None

  @property
  def visible(self) -> torch.Tensor:
    return (self.visible_logits > 0).float()


class _HeadMLP(nn.Module):
  """Flax nn.Sequential([Dense, LayerNorm, gelu, Dense, LayerNorm, gelu,
  Dense]): parameters under layers_0, 1, 3, 4 and 6."""

  def __init__(self, width: int, out_features: int, inner: int = 256):
    super().__init__()
    self.layers_0 = nn.Linear(width, inner)
    self.layers_1 = ssm_vit.LayerNorm(inner)
    self.layers_3 = nn.Linear(inner, inner)
    self.layers_4 = ssm_vit.LayerNorm(inner)
    self.layers_6 = nn.Linear(inner, out_features)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = gelu(self.layers_1(linear(x, self.layers_0)))
    x = gelu(self.layers_4(linear(x, self.layers_3)))
    return linear(x, self.layers_6)


class TAPNextTracker(nn.Module):
  """TAPNext point tracker."""

  def __init__(self, config: ssm_vit.SsmVitConfig = ssm_vit.SsmVitConfig(),
               soft_argmax_threshold: int = 20,
               softmax_temperature: float = 0.5):
    super().__init__()
    self.config = config
    self.soft_argmax_threshold = soft_argmax_threshold
    self.softmax_temperature = softmax_temperature
    self.backbone = ssm_vit.MaskedSequenceDecoder(config)
    self.visible_head = _HeadMLP(config.width, 1)
    self.coordinate_head = _HeadMLP(config.width, 512)

  def _decode(self, logits: torch.Tensor) -> torch.Tensor:
    """Truncated soft-argmax over the last axis; the first maximum is the
    peak."""
    idx = torch.arange(logits.shape[-1], dtype=torch.float32,
                       device=logits.device)
    peak = torch.argmax(logits, dim=-1, keepdim=True)
    mask = (torch.abs(peak - idx) <= self.soft_argmax_threshold).float()
    probs = torch.softmax(logits * self.softmax_temperature, dim=-1)
    probs = probs * mask
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return torch.sum(probs * idx, dim=-1)[..., None]

  def prediction_heads(self, query_feats: torch.Tensor):
    """[B, T, Q, C] features -> (tracks, track_logits, visible_logits),
    each [B, T, Q, ...], in float32."""
    query_feats = query_feats.float()
    position = self.coordinate_head(query_feats)  # [..., 512]
    visible_logits = self.visible_head(query_feats)
    coord_0, coord_1 = torch.split(position, position.shape[-1] // 2, dim=-1)
    tracks = torch.cat([self._decode(coord_0), self._decode(coord_1)], dim=-1)
    return tracks + 0.5, position, visible_logits

  def _results(self, feats):
    """Heads on [B, T, Q, C] features, transposed to [B, Q, T, ...]."""
    return tuple(v.transpose(1, 2) for v in self.prediction_heads(feats))

  def forward(self, video: torch.Tensor, query_points: torch.Tensor,
              query_padding: Optional[torch.Tensor] = None,
              return_cache: bool = False,
              intermediates: bool = True) -> TrackerResults:
    """Offline forward. video [B, T, H, W, 3] in [-1, 1]; query_points
    [B, Q, (hints,) 3] (t, y, x). With `intermediates`, the heads also run on
    every layer's output (deep supervision); without, those lists are
    empty."""
    _, query_feats, out = self.backbone(
        video, query_points, query_padding, intermediates)
    q = query_feats.shape[2]
    b, t = video.shape[:2]
    inter = ([], [], [])
    if intermediates:
      for lyr in range(self.config.depth):
        feats = out[f"block{lyr:02d}"]["vit_block_intermediates"]["+mlp"]
        feats = feats[:, -q:].reshape(b, t, q, feats.shape[-1])
        for dst, v in zip(inter, self._results(feats)):
          dst.append(v)
    tracks, logits, vis = self._results(query_feats)
    return TrackerResults(
        tracks=tracks, track_logits=logits, visible_logits=vis,
        intermediate_tracks=inter[0], intermediate_track_logits=inter[1],
        intermediate_visible_logits=inter[2],
        state=out.get("ssm_block_cache") if return_cache else None)

  def forward_step(self, frames: torch.Tensor,
                   query_points: Optional[torch.Tensor] = None,
                   query_padding: Optional[torch.Tensor] = None,
                   state: Optional[ssm_vit.TAPNextTrackingState] = None
                   ) -> TrackerResults:
    """Online rollout: the first call with query_points (a warm-up over the
    first chunk), later calls with the returned state only. No call
    computes the per-layer intermediate heads."""
    if state is None and query_points is None:
      raise ValueError("state and query_points cannot both be None.")
    if query_points is not None:
      results = self(frames, query_points, query_padding, return_cache=True,
                     intermediates=False)
      if query_padding is None:
        query_padding = torch.ones(query_points.shape[:-1], dtype=torch.bool,
                                   device=query_points.device)
      results.state = ssm_vit.TAPNextTrackingState(
          step=frames.shape[1], query_points=query_points,
          query_padding=query_padding, hidden_state=results.state)
      return results
    query_feats, new_state = self.backbone.forward_step(frames, state)
    tracks, logits, vis = self._results(query_feats)
    return TrackerResults(
        tracks=tracks, track_logits=logits, visible_logits=vis,
        intermediate_tracks=[], intermediate_track_logits=[],
        intermediate_visible_logits=[], state=new_state)


def tracker_certainty(tracks: torch.Tensor, track_logits: torch.Tensor,
                      radius: int = 8) -> torch.Tensor:
  """Probability mass of the coordinate softmax within `radius` bins of the
  prediction: tracks [..., 2] (y, x), track_logits [..., 512] -> [..., 1]."""
  coord_0, coord_1 = torch.split(track_logits, track_logits.shape[-1] // 2, -1)
  probs_0 = torch.softmax(coord_0, dim=-1)
  probs_1 = torch.softmax(coord_1, dim=-1)
  idx = torch.arange(coord_0.shape[-1], dtype=torch.float32,
                     device=track_logits.device)
  in_r0 = torch.abs(idx - tracks[..., 0:1]) <= radius
  in_r1 = torch.abs(idx - tracks[..., 1:2]) <= radius
  c0 = torch.sum(probs_0 * in_r0, dim=-1)
  c1 = torch.sum(probs_1 * in_r1, dim=-1)
  return (c0 * c1)[..., None]
