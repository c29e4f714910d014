"""TAPIR two-stage point tracker (port of tapnet_tpu/models/tapir.py:
offline inference, the causal streaming state of online TAPIR, and the
training forward).

Stage 1 initializes every query's trajectory from a global cost volume
(per-frame feature matching + soft-argmax); stage 2 refines it with 7x7
tent-interpolated local correlations over a feature pyramid
(`ops.corr_tents`) fed through a depthwise-conv MLP-Mixer across time
(`ops.fused_mixer_block`). Feature grids keep the JAX layout [B, T, H, W, C].

Online (causal) TAPIR runs `estimate_trajectories` one frame at a time with
a `TapirCausalState`: per refinement iteration and mixer block, the last
k-1 frames entering each temporal conv, carried from step to step.

Training (`is_training=True`) runs the query chunks in a random order drawn
from a `torch.Generator` (the identity without one, as JAX's without a
"permutation" rng); only the first chunk's refinement steps carry gradients,
the others' run under `torch.no_grad()`, and stage 1 trains on every chunk.
The backbone runs under `torch.utils.checkpoint` whenever a gradient is
recorded (JAX's `nn.remat`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tapnet_tpu_torch.models import resnet as resnet_lib
from tapnet_tpu_torch.models.layers import (
    Conv, ExtraConvs, MixerCache, PipsMixer, linear,
)
from tapnet_tpu_torch.ops import corr_tents
from tapnet_tpu_torch.utils import sampling, transforms


@dataclasses.dataclass(frozen=True)
class TapirConfig:
  """Static TAPIR hyperparameters (the JAX TapirConfig's fields that the
  offline inference path reads)."""

  num_pips_iter: int = 4
  pyramid_level: int = 1
  patch_size: int = 7
  softmax_temperature: float = 20.0
  mixer_hidden_dim: int = 512
  num_mixer_blocks: int = 12
  mixer_kernel_size: int = 3
  use_causal_conv: bool = False
  initial_resolution: Tuple[int, int] = (256, 256)
  blocks_per_group: Sequence[int] = (2, 2, 2, 2)
  extra_convs: bool = False
  highres_dim: int = 128
  lowres_dim: int = 256
  # "bfloat16" runs the backbone, correlations and mixer in bf16 with fp32
  # accumulations and fp32 normalization statistics; heads and soft-argmax
  # stay fp32.
  compute_dtype: str = "float32"
  # Inference speed mode: the mixer's channel MLPs in w8a8 int8 (per-row
  # dynamic activation scales, per-column weight scales, int32 accumulation).
  # Temporal convs, LayerNorms, heads and correlation stay in compute_dtype.
  quantized_mixer: bool = False
  # Inference speed mode: the local correlation in int8 with int32
  # accumulation and bfloat16 tents. "per_frame": one grid scale per frame,
  # the pyramid grids quantized once per video, and per-descriptor query
  # scales, all applied to the output. True: per-position grid scales,
  # quantized in every call.
  quantized_corr: "bool | str" = False
  # Inference speed mode: the ExtraConvs' 3x3 convolutions in w8a8 int8.
  # True: one activation scale per frame (`ops.qconv.conv2d_q8`);
  # "per_pixel": per-pixel scales with exact per-tap dequantization
  # (`ops.fused_extra_convs`, K6) where the JAX gate picks it, per-frame
  # elsewhere. LayerNorms, GELUs and the residual stream stay full precision.
  quantized_extra_convs: "bool | str" = False

  def __post_init__(self):
    if self.quantized_extra_convs not in (False, True, "per_pixel"):
      raise ValueError(f"quantized_extra_convs={self.quantized_extra_convs!r}")
    if self.quantized_corr not in (False, True, "per_frame"):
      raise ValueError(f"quantized_corr={self.quantized_corr!r}")

  @property
  def dtype(self) -> torch.dtype:
    return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def tapir_config(**overrides) -> TapirConfig:
  """Standard (offline) TAPIR."""
  kwargs = dict(pyramid_level=0, use_causal_conv=False)
  kwargs.update(overrides)
  return TapirConfig(**kwargs)


def causal_tapir_config(**overrides) -> TapirConfig:
  """Online/causal TAPIR: pyramid level 1, causal temporal convs."""
  kwargs = dict(pyramid_level=1, use_causal_conv=True)
  kwargs.update(overrides)
  return TapirConfig(**kwargs)


def bootstapir_config(**overrides) -> TapirConfig:
  """BootsTAPIR: pyramid level 1, ExtraConvs, softmax temperature 10."""
  kwargs = dict(
      pyramid_level=1,
      use_causal_conv=False,
      extra_convs=True,
      softmax_temperature=10.0,
  )
  kwargs.update(overrides)
  return TapirConfig(**kwargs)


def causal_bootstapir_config(**overrides) -> TapirConfig:
  """Online BootsTAPIR (causal convs + ExtraConvs)."""
  return bootstapir_config(use_causal_conv=True, **overrides)


class TapirCausalState(NamedTuple):
  """Streaming state of online TAPIR, one entry per refinement iteration
  and mixer block: `pre` the last (k-1) frames entering each block's first
  depthwise conv, `mid` the post-GELU frames entering the second. float32,
  pre [I, L, B, N, k-1, hidden], mid [I, L, B, N, k-1, 4*hidden]."""

  pre: torch.Tensor
  mid: torch.Tensor

  def num_points(self) -> int:
    return self.pre.shape[3]


class FeatureGrids(NamedTuple):
  """Backbone features per (initial + refinement) resolution, [B,T,H,W,C]."""

  lowres: Tuple[torch.Tensor, ...]
  hires: Tuple[torch.Tensor, ...]
  resolutions: Tuple[Tuple[int, int], ...]


class QueryFeatures(NamedTuple):
  """Per-query [B, N, C] descriptors sampled from the feature grids."""

  lowres: Tuple[torch.Tensor, ...]
  hires: Tuple[torch.Tensor, ...]
  resolutions: Tuple[Tuple[int, int], ...]


def _draw_permutation(generator: torch.Generator,
                      num_queries: int) -> torch.Tensor:
  """The training forward's query order: a random permutation of the
  queries from `generator`."""
  return torch.randperm(num_queries, generator=generator,
                        device=generator.device)


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
  """2x2 VALID average pool over the spatial dims of [B, T, H, W, C]."""
  b, t, h, w, c = x.shape
  x = x[:, :, : h // 2 * 2, : w // 2 * 2]
  x = x.reshape(b, t, h // 2, 2, w // 2, 2, c)
  return x.float().mean(dim=(3, 5)).to(x.dtype)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
  xf = x.float()
  out = xf * torch.rsqrt(torch.clamp(xf.square().sum(-1, keepdim=True), min=1e-12))
  return out.to(x.dtype)


def resize_video(video: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
  """Antialiased bilinear resize of [B, T, H, W, C] frames to out_hw.

  F.interpolate(mode="bilinear", antialias=True) computes the same weights
  as the JAX image.resize(method="bilinear") that the reference uses (a
  triangle kernel widened by the downsampling factor); the tests hold the
  two together. Resized in float32, returned in video.dtype.
  """
  b, t, h, w, c = video.shape
  if (h, w) == tuple(out_hw):
    return video
  frames = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2).float()
  out = F.interpolate(
      frames, size=tuple(out_hw), mode="bilinear", antialias=True,
      align_corners=False,
  )
  out = out.permute(0, 2, 3, 1).to(video.dtype)
  return out.reshape((b, t) + tuple(out_hw) + (c,))


class CostVolumeHead(nn.Module):
  """Stage-1 heads: cost volume -> position heatmap + occlusion/uncertainty."""

  def __init__(self, softmax_temperature: float = 20.0):
    super().__init__()
    self.softmax_temperature = softmax_temperature
    self.pos_conv = Conv(1, 16, 3)
    self.pos_out = Conv(16, 1, 3)
    self.occ_conv = Conv(16, 32, 3)
    self.occ_dense = nn.Linear(32, 16)
    self.occ_out = nn.Linear(16, 2)

  def forward(
      self,
      query_feats: torch.Tensor,  # [B, N, C]
      feature_grid: torch.Tensor,  # [B, T, H, W, C]
      query_points: Optional[torch.Tensor],  # [B, N, 3] tyx, initial res
      im_shape: Sequence[int],  # [B, T, H_im, W_im, 3] at initial res
  ):
    b, t, h, w, _ = feature_grid.shape
    n = query_feats.shape[1]
    # Time-major cost volume [T, B, N, H, W], float32 accumulation.
    cost = torch.einsum(
        "bnc,bthwc->tbnhw", query_feats.float(), feature_grid.float()
    )
    cost = cost.reshape(t * b * n, 1, h, w)
    hid = torch.relu(self.pos_conv(cost))

    pos = self.pos_out(hid)
    pos = pos.reshape(t, b, n, h, w).permute(1, 2, 0, 3, 4)
    pos = torch.softmax(
        (pos * self.softmax_temperature).reshape(b, n, t, h * w), dim=-1
    ).reshape(b, n, t, h, w)
    points = sampling.heatmaps_to_points(
        pos, im_shape, query_points=query_points
    )

    occ = torch.relu(self.occ_conv(hid, stride=2))
    occ = occ.mean(dim=(2, 3))
    occ = torch.relu(linear(occ, self.occ_dense))
    occ = linear(occ, self.occ_out)
    occ = occ.reshape(t, b, n, 2)
    occlusion = occ[..., 0].permute(1, 2, 0)
    expected_dist = occ[..., 1].permute(1, 2, 0)
    return points, occlusion, expected_dist


class TAPIR(nn.Module):
  """TAPIR tracker, offline inference. See module docstring."""

  def __init__(self, config: TapirConfig = TapirConfig()):
    super().__init__()
    cfg = self.config = config
    self.backbone = resnet_lib.ResNet(
        resnet_lib.ResNetConfig(
            blocks_per_group=tuple(cfg.blocks_per_group),
            channels_per_group=(64, cfg.highres_dim, 256, cfg.lowres_dim),
        )
    )
    self.extra = (
        ExtraConvs(cfg.lowres_dim, quantized=cfg.quantized_extra_convs)
        if cfg.extra_convs else None
    )
    self.cost_volume_head = CostVolumeHead(cfg.softmax_temperature)
    p2 = cfg.patch_size**2
    feats = cfg.highres_dim + cfg.lowres_dim
    self.mixer = PipsMixer(
        input_channels=4 + feats + p2 * (2 + cfg.pyramid_level),
        output_channels=4 + feats,
        hidden_dim=cfg.mixer_hidden_dim,
        num_blocks=cfg.num_mixer_blocks,
        kernel_size=cfg.mixer_kernel_size,
        causal=cfg.use_causal_conv,
        quantized=cfg.quantized_mixer,
    )

  # ---------------------------------------------------------------- features

  def get_feature_grids(
      self,
      video: torch.Tensor,
      refinement_resolutions: Optional[List[Tuple[int, int]]] = None,
  ) -> FeatureGrids:
    """Runs the backbone at every required resolution.

    Args:
      video: [B, T, H, W, 3] in [-1, 1].
      refinement_resolutions: (height, width) list; inferred log-spaced from
        the video size if None.
    """
    cfg = self.config
    if refinement_resolutions is None:
      refinement_resolutions = sampling.generate_default_resolutions(
          tuple(video.shape[2:4]), cfg.initial_resolution
      )
    all_resolutions = [tuple(cfg.initial_resolution)] + [
        tuple(r) for r in refinement_resolutions
    ]

    lowres, hires = [], []
    cached: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
    video_c = video.to(cfg.dtype)
    for resolution in all_resolutions:
      if resolution[0] % 8 != 0 or resolution[1] % 8 != 0:
        raise ValueError("Image resolution must be a multiple of 8.")
      if resolution not in cached:
        resized = resize_video(video_c, resolution)
        latent, hi = self._backbone_features(resized)
        cached[resolution] = (_l2_normalize(latent), _l2_normalize(hi))
      lo, hi = cached[resolution]
      lowres.append(lo)
      hires.append(hi)
    return FeatureGrids(tuple(lowres), tuple(hires), tuple(all_resolutions))

  def _backbone_features(self, video: torch.Tensor):
    """ResNet (+ ExtraConvs) over all frames -> [B, T, H, W, C] grids."""
    b, t = video.shape[:2]
    # NHWC frames viewed as NCHW: a channels-last tensor.
    frames = video.reshape((b * t,) + tuple(video.shape[2:])).permute(0, 3, 1, 2)
    if torch.is_grad_enabled():
      feats = torch.utils.checkpoint.checkpoint(self.backbone, frames,
                                                use_reentrant=False)
    else:
      feats = self.backbone(frames)
    lo, hi = feats["group_3"], feats["group_1"]
    if self.extra is not None:
      lo = self.extra(lo)
    grids = []
    for feat in (lo, hi):
      nhwc = feat.permute(0, 2, 3, 1)
      grids.append(nhwc.reshape((b, t) + tuple(nhwc.shape[1:])))
    return tuple(grids)

  # ------------------------------------------------------------- query feats

  def get_query_features(
      self,
      video_shape: Sequence[int],
      query_points: torch.Tensor,
      feature_grids: FeatureGrids,
  ) -> QueryFeatures:
    """Samples per-query [B, N, C] descriptors from every resolution's grids.

    query_points: [B, N, 3] (t, y, x) raster points in video coordinates.
    """
    lowres_feats, hires_feats = [], []
    cached: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
    for i, res in enumerate(feature_grids.resolutions):
      if res not in cached:
        grids = (feature_grids.lowres[i], feature_grids.hires[i])
        cached[res] = tuple(
            sampling.sample_grid_batched(
                grid,
                transforms.convert_grid_coordinates(
                    query_points,
                    tuple(video_shape)[1:4],
                    tuple(grid.shape[1:4]),
                    coordinate_format="tyx",
                ),
            )
            for grid in grids
        )
      lo, hi = cached[res]
      lowres_feats.append(lo)
      hires_feats.append(hi)
    return QueryFeatures(
        tuple(lowres_feats), tuple(hires_feats), feature_grids.resolutions
    )

  # -------------------------------------------------------------- refinement

  def _corr_patches(
      self,
      grid,  # [B, T, H, W, C], or (int8 grid, scale) pre-quantized
      query: torch.Tensor,  # [B, N, C] (first iteration) or [B, N, T, C]
      pos_guess: torch.Tensor,  # [B, N, T, 2] xy at initial resolution
      orig_hw: Tuple[int, int],
  ) -> torch.Tensor:
    """[B, N, T, p*p] 7x7 local correlation around the current track."""
    cfg = self.config
    p = cfg.patch_size
    orig_h, orig_w = orig_hw
    # int8 grids arrive quantized (see estimate_trajectories), as (int8,
    # [B, T] scale) tuples per frame and (int8, [B, T, H, W] scale) tuples
    # per position.
    prequant = isinstance(grid, tuple)
    grid_arr = grid[0] if prequant else grid
    b, t, h, w, c = grid_arr.shape
    n = query.shape[1]
    coords = transforms.convert_grid_coordinates(
        pos_guess, (orig_w, orig_h), (w, h)
    ).flip(-1)  # (y, x) raster
    if query.ndim == 4:
      q_bt = query.permute(0, 2, 1, 3)
    else:
      q_bt = query[:, None].expand(b, t, n, c)
    q_bt = q_bt.reshape(b * t, n, c).to(cfg.dtype).contiguous()
    cyx = coords - 0.5  # index space
    cy = cyx[..., 0].permute(0, 2, 1).reshape(b * t, n).contiguous()
    cx = cyx[..., 1].permute(0, 2, 1).reshape(b * t, n).contiguous()
    if prequant and cfg.quantized_corr == "per_frame":
      pat = corr_tents.corr_tent_patches_prequantized(
          grid_arr.reshape(b * t, h, w, c), grid[1].reshape(b * t), q_bt,
          cy, cx, p,
      )
    elif prequant:
      pat = corr_tents.corr_tent_patches_prequantized_per_position(
          grid_arr.reshape(b * t, h, w, c), grid[1].reshape(b * t, h, w),
          q_bt, cy, cx, p,
      )
    else:
      grid_bt = grid.reshape(b * t, h, w, c).to(cfg.dtype).contiguous()
      pat = corr_tents.corr_tent_patches(
          grid_bt, q_bt, cy, cx, p, cfg.quantized_corr
      )
    # [B*T, p, p, N] -> [B, N, T, p*p]
    pat = pat.reshape(b, t, p, p, n).permute(0, 4, 1, 2, 3)
    return pat.reshape(b, n, t, p * p)

  def _refine_pips(
      self,
      queries: Sequence[torch.Tensor],
      pyramid: Sequence[torch.Tensor],
      pos_guess: torch.Tensor,
      occ_guess: torch.Tensor,
      expd_guess: torch.Tensor,
      orig_hw: Tuple[int, int],
      resize_hw: Tuple[int, int],
      mixer_feats: Optional[torch.Tensor],
      cache: Optional[MixerCache] = None,
      return_cache: bool = False,
  ):
    """One PIPs refinement step. `cache` ([L, B, N, ...] per leaf) streams
    the mixer; with `return_cache` the step also returns the new one."""
    cfg = self.config
    corrs_pyr = []
    for pyridx, (query, grid) in enumerate(zip(queries, pyramid)):
      if mixer_feats is None:
        q = query
      elif pyridx == 0:
        q = mixer_feats[..., : cfg.highres_dim]
      else:
        q = mixer_feats[..., cfg.highres_dim :]
      corrs_pyr.append(self._corr_patches(grid, q, pos_guess, orig_hw))
    corrs = torch.cat(corrs_pyr, dim=-1)

    t = corrs.shape[2]
    if mixer_feats is None:
      both = torch.cat([queries[0], queries[1]], dim=-1)
      feats = both[:, :, None, :].expand(-1, -1, t, -1)
    else:
      feats = mixer_feats

    mlp_input = torch.cat(
        [
            torch.zeros_like(pos_guess),
            occ_guess[..., None],
            expd_guess[..., None],
            feats.to(pos_guess.dtype),
            corrs,
        ],
        dim=-1,
    )
    b, n, t, c = mlp_input.shape
    x = mlp_input.reshape(b * n, t, c).to(cfg.dtype)
    if cache is not None:
      cache = MixerCache(*(v.reshape((v.shape[0], b * n) + v.shape[3:])
                           for v in cache))
    new_cache = None
    if return_cache:
      res, new_cache = self.mixer(x, cache, True)
      new_cache = MixerCache(*(v.reshape((v.shape[0], b, n) + v.shape[2:])
                               for v in new_cache))
    else:
      res = self.mixer(x, cache)
    res = res.reshape(b, n, t, res.shape[-1])

    orig_h, orig_w = orig_hw
    resized_h, resized_w = resize_hw
    pos_update = transforms.convert_grid_coordinates(
        res[..., :2], (resized_w, resized_h), (orig_w, orig_h)
    )
    return (
        pos_update + pos_guess,
        res[..., 2] + occ_guess,
        res[..., 3] + expd_guess,
        res[..., 4:] + feats,
        new_cache,
    )

  # ------------------------------------------------------------ trajectories

  def _track_chunk(self, pyramids, feature_grids, qf_low, qf_hi, qp,
                   im_shape, video_size, num_iters, state=None,
                   get_causal_context=False, refine_grad=True):
    """Stage 1 + every refinement iteration for one query chunk.

    Returns [iters+1, B, n, T, 2] points and [iters+1, B, n, T] occlusion and
    expected_dist logits, and with `get_causal_context` the chunk's new
    TapirCausalState (else None). `state` is the chunk's slice of the
    causal state, or None. Without `refine_grad` the refinement iterations
    run under `torch.no_grad()`; stage 1 keeps its gradient.
    """
    cfg = self.config

    def train2orig(x):
      return transforms.convert_grid_coordinates(
          x, cfg.initial_resolution[::-1], tuple(video_size)[::-1],
          coordinate_format="xy",
      )

    points, occlusion, expected_dist = self.cost_volume_head(
        qf_low[0], feature_grids.lowres[0], qp, im_shape
    )
    pts_i, occ_i, expd_i = [train2orig(points)], [occlusion], [expected_dist]
    init_occ, init_expd = occlusion, expected_dist

    mixer_feats = None
    new_states = []
    with torch.set_grad_enabled(refine_grad and torch.is_grad_enabled()):
      for i in range(num_iters):
        level = i // cfg.num_pips_iter + 1
        queries = [qf_hi[level], qf_low[level]]
        queries += [queries[-1]] * cfg.pyramid_level
        cache = (None if state is None
                 else MixerCache(state.pre[i], state.mid[i]))
        points, occlusion, expected_dist, mixer_feats, new_cache = (
            self._refine_pips(
                queries,
                pyramids[level - 1],
                points,
                occlusion,
                expected_dist,
                orig_hw=cfg.initial_resolution,
                resize_hw=feature_grids.resolutions[level],
                mixer_feats=mixer_feats,
                cache=cache,
                return_cache=get_causal_context,
            ))
        new_states.append(new_cache)
        pts_i.append(train2orig(points))
        occ_i.append(occlusion)
        expd_i.append(expected_dist)
        if (i + 1) % cfg.num_pips_iter == 0:
          # Next resolution starts again from the stage-1 estimate.
          mixer_feats = None
          occlusion, expected_dist = init_occ, init_expd
    new_state = None
    if get_causal_context:
      new_state = TapirCausalState(
          pre=torch.stack([c.pre for c in new_states]),
          mid=torch.stack([c.mid for c in new_states]))
    return (torch.stack(pts_i), torch.stack(occ_i), torch.stack(expd_i),
            new_state)

  def estimate_trajectories(
      self,
      video_size: Tuple[int, int],
      feature_grids: FeatureGrids,
      query_features: QueryFeatures,
      query_points_in_video: Optional[torch.Tensor] = None,
      query_chunk_size: Optional[int] = None,
      causal_state: Optional[TapirCausalState] = None,
      get_causal_context: bool = False,
      is_training: bool = False,
      generator: Optional[torch.Generator] = None,
      query_shard: Optional[Tuple[int, int]] = None,
  ) -> Mapping[str, Any]:
    """Stage 1 + stage 2 over all queries, one query chunk at a time.

    Returns per-iteration lists under "tracks" / "occlusion" /
    "expected_dist" (index 0 = cost-volume init), and with
    `get_causal_context` the new TapirCausalState under "causal_context".
    `causal_state` streams the mixers (each chunk reads its queries' slice).
    The chunks are a static loop, the last one ragged; chunks are
    independent, so the outputs do not depend on the chunk size.

    `is_training`: the chunks take the queries in the order of a random
    permutation drawn from `generator` (the identity without one; outputs
    come back in query order), the refinement of every chunk after the
    first runs without gradient (JAX stops it), and the grids are quantized
    in each correlation call (the pre-quantized routes have no gradient).

    `query_shard` (offset, total): these queries are the global queries
    [offset, offset + N) of `total`, split over ranks. The chunks are then
    those of the global queries (the permutation is drawn over `total`), each
    cut to this rank's queries, so that which queries keep the refinement's
    gradient is the unsplit forward's.
    """
    cfg = self.config
    if is_training and causal_state is not None:
      raise ValueError("Training with causal state is not supported.")
    num_resolutions = len(feature_grids.lowres) - 1
    num_iters = cfg.num_pips_iter * num_resolutions
    num_queries = query_features.lowres[0].shape[1]
    chunk = query_chunk_size or num_queries
    device = query_features.lowres[0].device

    pyramids = []
    for level in range(1, num_resolutions + 1):
      pyramid = [feature_grids.hires[level], feature_grids.lowres[level]]
      for _ in range(cfg.pyramid_level):
        pyramid.append(_avg_pool_2x(pyramid[-1]))
      pyramids.append(pyramid)
    if cfg.quantized_corr and not is_training:
      # Quantize every pyramid grid once per video, per frame or per
      # position: the chunks and the refinement iterations all read the same
      # int8 grids and scales (a position's scale does not depend on the
      # query). A grid may be a channels-last view of the backbone's output;
      # the kernel reads dense [B, T, H, W, C], and the int8 copy is made
      # dense here, once.
      quantize = (corr_tents.quantize_per_frame
                  if cfg.quantized_corr == "per_frame"
                  else corr_tents.quantize_per_position)
      pyramids = [
          [quantize(g.to(cfg.dtype).contiguous()) for g in pyr]
          for pyr in pyramids
      ]

    im_shape = (
        tuple(feature_grids.lowres[0].shape[0:2])
        + tuple(cfg.initial_resolution) + (3,)
    )
    num_frames = feature_grids.lowres[0].shape[1]
    offset, total = query_shard or (0, num_queries)
    perm = None
    if is_training and generator is not None:
      perm = _draw_permutation(generator, total).long().cpu()
    if perm is None and query_shard is None:
      index = torch.arange(num_queries, device=device)
      chunks = list(index.split(chunk))
      inverse = None
    else:
      # Each global chunk cut to this rank's queries (local indices), worked
      # out on the host and copied once.
      index = torch.arange(total) if perm is None else perm
      chunks = [c[(c >= offset) & (c < offset + num_queries)] - offset
                for c in index.split(chunk)]
      inverse = torch.argsort(torch.cat(chunks)).to(device)
      chunks = list(torch.cat(chunks).to(device).split(
          [len(c) for c in chunks]))

    outs = []
    for ch, idx in enumerate(chunks):
      if not len(idx):
        continue
      qp = None
      if query_points_in_video is not None:
        qp = transforms.convert_grid_coordinates(
            query_points_in_video[:, idx],
            (num_frames,) + tuple(video_size),
            (num_frames,) + tuple(cfg.initial_resolution),
            coordinate_format="tyx",
        )
      state = None
      if causal_state is not None:
        state = TapirCausalState(*(v[:, :, :, idx] for v in causal_state))
      outs.append(self._track_chunk(
          pyramids,
          feature_grids,
          [qf[:, idx] for qf in query_features.lowres],
          [qf[:, idx] for qf in query_features.hires],
          qp,
          im_shape,
          video_size,
          num_iters,
          state,
          get_causal_context,
          refine_grad=not (is_training and ch > 0),
      ))
    unpermute = lambda x, axis: x if inverse is None else x.index_select(
        axis, inverse)
    points, occ, expd = (
        unpermute(torch.cat(parts, dim=2), 2)
        for parts in list(zip(*outs))[:3]
    )
    out = dict(
        tracks=list(points), occlusion=list(occ), expected_dist=list(expd)
    )
    if get_causal_context:
      out["causal_context"] = TapirCausalState(*(
          unpermute(torch.cat(parts, dim=3), 3)
          for parts in zip(*(o[3] for o in outs))))
    return out

  # ------------------------------------------------------------ online state

  def construct_initial_causal_state(
      self, batch_size: int, num_points: int, num_resolutions: int = 1
  ) -> TapirCausalState:
    """Zero float32 streaming state for `num_points` tracks, on the model's
    device."""
    cfg = self.config
    device = self.mixer.in_proj.weight.device
    lead = (cfg.num_pips_iter * num_resolutions, cfg.num_mixer_blocks,
            batch_size, num_points, cfg.mixer_kernel_size - 1)
    zeros = lambda width: torch.zeros(lead + (width,), dtype=torch.float32,
                                      device=device)
    return TapirCausalState(pre=zeros(cfg.mixer_hidden_dim),
                            mid=zeros(cfg.mixer_hidden_dim * 4))

  # ----------------------------------------------------------------- forward

  def forward(
      self,
      video: torch.Tensor,
      query_points: torch.Tensor,
      query_chunk_size: Optional[int] = None,
      refinement_resolutions: Optional[List[Tuple[int, int]]] = None,
      feature_grids: Optional[FeatureGrids] = None,
      is_training: bool = False,
      generator: Optional[torch.Generator] = None,
      query_shard: Optional[Tuple[int, int]] = None,
  ) -> Mapping[str, Any]:
    """Full forward pass.

    Args:
      video: [B, T, H, W, 3] in [-1, 1].
      query_points: [B, N, 3] (t, y, x) raster points in video coordinates.
      query_chunk_size: memory-bounding chunk over queries.
      refinement_resolutions: optional explicit refinement sizes.
      feature_grids: reuse precomputed grids.
      is_training: the training forward (`estimate_trajectories`).
      generator: with `is_training`, draws the chunks' query order.
      query_shard: (offset, total) when the queries are a part of `total`
        split over ranks (`estimate_trajectories`).

    Returns:
      dict with "tracks" [B, N, T, 2] (x, y raster), "occlusion" and
      "expected_dist" logits [B, N, T], plus per-iteration "unrefined_*".
    """
    cfg = self.config
    if feature_grids is None:
      feature_grids = self.get_feature_grids(video, refinement_resolutions)
    query_features = self.get_query_features(
        video.shape, query_points, feature_grids
    )
    trajectories = self.estimate_trajectories(
        tuple(video.shape[-3:-1]),
        feature_grids,
        query_features,
        query_points_in_video=query_points,
        query_chunk_size=query_chunk_size,
        is_training=is_training,
        generator=generator,
        query_shard=query_shard,
    )
    # Final prediction: mean over the last refinement of each resolution.
    p = cfg.num_pips_iter

    def last_of_each(key):
      return torch.stack(trajectories[key][p::p]).mean(dim=0)

    return dict(
        occlusion=last_of_each("occlusion"),
        tracks=last_of_each("tracks"),
        expected_dist=last_of_each("expected_dist"),
        unrefined_occlusion=trajectories["occlusion"][:-1],
        unrefined_tracks=trajectories["tracks"][:-1],
        unrefined_expected_dist=trajectories["expected_dist"][:-1],
    )


def lecun_normal(shape, fan_in: int, generator: torch.Generator):
  """Flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
  a normal truncated at 2 standard deviations, rescaled to variance
  1 / fan_in."""
  out = torch.empty(shape)
  torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
  return (out * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).numpy()


# The standard deviation of a standard normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def init_tapir_params(config: TapirConfig,
                      generator: torch.Generator) -> Dict[str, Any]:
  """The TAPIR parameter tree of a fresh training run, in the Flax layout
  with numpy leaves, drawn from `generator` (a CPU generator).

  The distributions are those of the JAX modules' Flax initialisers: every
  kernel (the ResNet's, the ExtraConvs', the heads', the mixer's dense and
  depthwise ones) LeCun's truncated normal over its fan-in (kh * kw * C_in
  for a conv, the input width for a dense layer, k for a [k, 1, D]
  depthwise kernel), except the ExtraConvs' `conv_out_i`, which are zero;
  every bias and norm offset 0 and every norm scale 1."""
  model = TAPIR(config)
  tree: Dict[str, Any] = {}
  for name, p in model.named_parameters():
    path = name.split(".")
    leaf, shape = path[-1], tuple(p.shape)
    if leaf == "weight":
      leaf = "kernel"
      if len(shape) == 4:
        shape = (shape[2], shape[3], shape[1], shape[0])
      elif len(shape) == 2:
        shape = shape[::-1]
      fan_in = int(np.prod(shape[:-1]))
      if path[0] == "extra" and path[1].startswith("conv_out_"):
        value = np.zeros(shape, np.float32)
      else:
        value = lecun_normal(shape, fan_in, generator)
    else:
      value = np.full(shape, 1.0 if leaf == "scale" else 0.0, np.float32)
    node = tree
    for part in path[:-1]:
      node = node.setdefault(part, {})
    node[leaf] = value
  return tree


def update_query_features(
    query_features: QueryFeatures,
    new_query_features: QueryFeatures,
    idx_to_update: Sequence[int],
    causal_state: Optional[TapirCausalState] = None,
    fresh_state: Optional[TapirCausalState] = None,
):
  """New query descriptors (and fresh streaming state) in the slots
  `idx_to_update` of copies of the old ones. Returns the QueryFeatures, and
  the TapirCausalState too when `causal_state` is given."""
  idx = torch.as_tensor(list(idx_to_update), dtype=torch.long)

  def set_queries(olds, news):
    out = []
    for old, new in zip(olds, news):
      old = old.clone()
      old[:, idx.to(old.device)] = new.to(old.dtype)
      out.append(old)
    return tuple(out)

  qf = QueryFeatures(
      lowres=set_queries(query_features.lowres, new_query_features.lowres),
      hires=set_queries(query_features.hires, new_query_features.hires),
      resolutions=query_features.resolutions,
  )
  if causal_state is None:
    return qf
  if fresh_state is None:
    raise ValueError("fresh_state required to reset causal state.")
  new_state = []
  for old, new in zip(causal_state, fresh_state):
    old = old.clone()
    old[:, :, :, idx.to(old.device)] = new.to(old.dtype)
    new_state.append(old)
  return qf, TapirCausalState(*new_state)
