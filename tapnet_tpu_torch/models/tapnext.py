"""TAPNext tracker: ViT-SSM backbone + quantized-coordinate heads (port of
tapnet_tpu/models/tapnext.py).

Coordinates are 512 logits split into two 256-bin axes, decoded by a
truncated soft-argmax (threshold 20 bins, temperature 0.5, +0.5 raster
offset), in float32 whatever the backbone's compute dtype. Query points are
(t, y, x); output tracks are (y, x) in model raster coordinates. With
`config.sp_mesh` the clip runs time-split over ranks (`ssm_vit`) and the
heads' outputs are gathered over time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from tapnet_tpu_torch.models import ssm_vit
from tapnet_tpu_torch.models.layers import linear
from tapnet_tpu_torch.ops.mixer_math import gelu
from tapnet_tpu_torch.parallel import mesh as mesh_lib


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

  def _results(self, feats, sp=None):
    """Heads on [B, T, Q, C] features, transposed to [B, Q, T, ...]; under
    `sp` the features are this rank's frames and the outputs are gathered
    over time."""
    outs = tuple(v.transpose(1, 2) for v in self.prediction_heads(feats))
    if sp is not None:
      outs = tuple(mesh_lib.gather(v, sp[0], sp[1], dim=2) for v in outs)
    return outs

  def forward(self, video: torch.Tensor, query_points: torch.Tensor,
              query_padding: Optional[torch.Tensor] = None,
              return_cache: bool = False,
              intermediates: bool = True) -> TrackerResults:
    """Offline forward. video [B, T, H, W, 3] in [-1, 1]; query_points
    [B, Q, (hints,) 3] (t, y, x). With `intermediates`, the heads also run on
    every layer's output (deep supervision); without, those lists are
    empty. Under sequence parallelism (`config.sp_mesh`) every rank takes
    the whole clip and returns the whole results."""
    sp = self.backbone.sp_for(video.shape[1])
    _, query_feats, out = self.backbone(
        video, query_points, query_padding, intermediates)
    b, t, q = query_feats.shape[:3]
    inter = ([], [], [])
    if intermediates:
      for lyr in range(self.config.depth):
        feats = out[f"block{lyr:02d}"]["vit_block_intermediates"]["+mlp"]
        feats = feats[:, -q:].reshape(b, t, q, feats.shape[-1])
        for dst, v in zip(inter, self._results(feats, sp)):
          dst.append(v)
    tracks, logits, vis = self._results(query_feats, sp)
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
    sp = self.backbone.sp_for(frames.shape[1])
    query_feats, new_state = self.backbone.forward_step(frames, state)
    tracks, logits, vis = self._results(query_feats, sp)
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


# Flax's truncated normal divides its deviation by that of a unit normal
# truncated at +-2.
_TRUNC_STD = 0.87962566103423978


class _Init:
  """Flax's initialisers, drawn in float32 from one torch.Generator in the
  order the arrays are asked for."""

  def __init__(self, generator: torch.Generator):
    self.gen = generator

  def truncated(self, shape, variance, fan_in):
    """variance_scaling(variance, "fan_in", "truncated_normal")."""
    out = torch.empty(shape)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
    return (out * (math.sqrt(variance / fan_in) / _TRUNC_STD)).numpy()

  def xavier(self, shape, fan_in, fan_out):
    """xavier_uniform: uniform in +-sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.rand(shape, generator=self.gen) * (2 * limit) - limit
    return out.numpy()

  def normal(self, shape, std):
    return (torch.randn(shape, generator=self.gen) * std).numpy()

  @staticmethod
  def const(shape, value):
    return np.full(shape, value, np.float32)

  def dense(self, fan_in, fan_out, variance=1.0):
    """nn.Dense: lecun_normal (or the given fan-in variance), zero bias."""
    return {"kernel": self.truncated((fan_in, fan_out), variance, fan_in),
            "bias": self.const((fan_out,), 0.0)}

  def layer_norm(self, width):
    return {"scale": self.const((width,), 1.0),
            "bias": self.const((width,), 0.0)}


def _init_ssm_block(m: _Init, width, mlp_dim, lru_width, num_heads, depth):
  bw = lru_width // num_heads
  final = 2.0 / depth
  # Griffin: a uniform in [0.9, 0.999], softplus(a_param) = -log(a) / 8.
  u = torch.rand((lru_width,), generator=m.gen) * (0.999 - 0.9) + 0.9
  a_param = torch.log(torch.expm1(-torch.log(u) / 8.0)).numpy()
  # Flax's fan-in of a [H, bw, bw] kernel counts the leading axis: H * bw.
  gate = lambda: {"w": m.truncated((num_heads, bw, bw), 1.0, num_heads * bw),
                  "b": m.const((num_heads, bw), 0.0)}
  return {
      "temporal_pre_norm": {"scale": m.const((width,), 0.0)},
      "recurrent_block": {
          "linear_y": m.dense(width, lru_width),
          "linear_x": m.dense(width, lru_width),
          "conv_1d": {"w": m.truncated((4, lru_width), 0.01, 4),
                      "b": m.const((lru_width,), 0.0)},
          "rg_lru": {"a_param": a_param, "input_gate": gate(),
                     "a_gate": gate()},
          "linear_out": m.dense(lru_width, width, final),
      },
      "channel_pre_norm": {"scale": m.const((width,), 0.0)},
      "mlp_block": {
          # in_axis 1, out_axis 2 of [2, d, D]: the fan-in is 2 * d.
          "ffw_up": {"w": m.truncated((2, width, mlp_dim), 1.0, 2 * width),
                     "b": m.const((2, 1, 1, mlp_dim), 0.0)},
          "ffw_down": m.dense(mlp_dim, width, final),
      },
  }


def _init_vit_block(m: _Init, width, mlp_dim, num_heads):
  hd = width // num_heads
  attention = lambda: {"kernel": m.xavier((width, num_heads, hd), width, width),
                       "bias": m.const((num_heads, hd), 0.0)}
  return {
      "LayerNorm_0": m.layer_norm(width),
      "MultiHeadDotProductAttention_0": {
          "query": attention(), "key": attention(), "value": attention(),
          "out": {"kernel": m.xavier((num_heads, hd, width), width, width),
                  "bias": m.const((width,), 0.0)},
      },
      "LayerNorm_1": m.layer_norm(width),
      "MlpBlock_0": {
          "Dense_0": {"kernel": m.xavier((width, mlp_dim), width, mlp_dim),
                      "bias": m.normal((mlp_dim,), 1e-6)},
          "Dense_1": {"kernel": m.xavier((mlp_dim, width), mlp_dim, width),
                      "bias": m.normal((width,), 1e-6)},
      },
  }


def _init_head(m: _Init, width, out_features, inner=256):
  return {"layers_0": m.dense(width, inner), "layers_1": m.layer_norm(inner),
          "layers_3": m.dense(inner, inner), "layers_4": m.layer_norm(inner),
          "layers_6": m.dense(inner, out_features)}


def init_tapnext_params(config: ssm_vit.SsmVitConfig,
                        generator: torch.Generator) -> Dict[str, Any]:
  """The TAPNextTracker parameter tree of a fresh training run, in the Flax
  layout with numpy leaves, drawn from `generator` (a CPU generator).

  The distributions are those of the JAX modules' Flax initialisers: LeCun
  truncated normals for dense, patch-embedding and block-diagonal kernels,
  Xavier-uniform for the ViT blocks, 2/depth fan-in variance for the SSM
  block's two output projections, 0.01 for the temporal conv, Griffin's
  `a_param`, normal(1/sqrt(width)) tokens and position embeddings,
  normal(1e-6) MLP biases; every other bias and norm offset exactly 0 and
  every LayerNorm scale exactly 1 (RMSNorm scales 0)."""
  m = _Init(generator)
  c = config.width
  mlp_dim = config.mlp_dim or 4 * c
  ssm_width = 2 * c if config.bidirectional_ssm else c
  lru_width = config.lru_width or ssm_width
  _, ph, pw = config.patch_size
  h = config.image_size[0] // ph
  w = config.image_size[1] // pw
  token_std = 1.0 / math.sqrt(c)

  transformer = {}
  for lyr in range(config.depth):
    transformer[f"encoderblock_{lyr}"] = {
        "ssm_block": _init_ssm_block(m, ssm_width, mlp_dim, lru_width,
                                     config.num_heads, config.depth),
        "vit_block": _init_vit_block(m, c, mlp_dim, config.num_heads),
    }
  transformer["encoder_norm"] = m.layer_norm(c)
  backbone = {
      "embedding": {"kernel": m.truncated((1, ph, pw, 3, c), 1.0, ph * pw * 3),
                    "bias": m.const((c,), 0.0)},
      "Transformer": transformer,
      "mask_token": m.normal((1, 1, 1, c), token_std),
      "unknown_token": m.normal((1, 1, c), token_std),
      "point_query_token": m.normal((1, 1, 1, c), token_std),
  }
  if config.posemb == "learn":
    backbone["pos_embedding"] = m.normal((1, h * w, c), token_std)
  if config.posemb_full == "learn":
    full = config.image_size[0] * config.image_size[1] * config.query_scale**2
    backbone["pos_embedding_full"] = m.normal((1, full, c), token_std)
  return {"backbone": backbone, "visible_head": _init_head(m, c, 1),
          "coordinate_head": _init_head(m, c, 512)}
