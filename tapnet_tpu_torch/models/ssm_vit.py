"""ViT-SSM backbone of TAPNext (port of tapnet_tpu/models/ssm_vit.py).

Each layer runs a Griffin recurrent block over time (per token tube) and then
a ViT attention block over the tokens of a frame. Queries are extra tokens
scattered over time as [XY] / [U] / [M] tokens (`embed_queries_and_hints`).

Module and parameter names follow the Flax tree
(backbone/Transformer/encoderblock_{i}/{ssm_block,vit_block}/...; the
converter `checkpoints/convert.tapnext_to_state_dict` maps it). Attention
keeps Flax's semantics: q/k/v/out projections in `dtype_mm`, the query
divided by sqrt(head_dim) in that dtype, masks where True means "attend"
(a masked score is the dtype's lowest value, so a row masked everywhere
attends uniformly, as in Flax). The product itself is
`F.scaled_dot_product_attention` with scale 1: the JAX package leaves
attention to XLA, outside any Pallas kernel. In bfloat16 the card's fused
attention keeps its softmax in float32 where Flax rounds it to bfloat16.

`compute_dtype="bfloat16"` runs the attention and MLP products of the ViT
blocks and the final LayerNorm's output in bfloat16; the parameters, the
residual stream, the whole SSM block (its products included) and the heads
stay float32, as in the JAX package. With `remat`, each ViT-SSM block's
activations are recomputed in the backward (`torch.utils.checkpoint`, as the
JAX package's `nn.remat`): only the blocks' inputs stay stored.
`TokenSubsampling` masks a random suffix of the frames' tokens (TAPNext's
training-time degradation; no model of either package instantiates it).

Sequence parallelism (`sp_mesh`, `sp_axis`): the offline forward and a
multi-frame `forward_step` take the whole clip on every rank, run the patch
embedding, the attention and the MLPs on this rank's part of the frames
only, and the recurrent blocks over the ranks (`parallel/sequence.py`);
`TAPNextTracker` gathers the heads' outputs over time, so every rank returns
the unsharded model's results. The time-reversed half of a
`bidirectional_ssm` block is global: rank r's reversed part is the reverse of
rank P-1-r's part, which it takes from an all-gather.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tapnet_tpu_torch.models import rglru
from tapnet_tpu_torch.models.layers import linear
from tapnet_tpu_torch.ops import mixer_math
from tapnet_tpu_torch.ops.mixer_math import gelu
from tapnet_tpu_torch.parallel import sequence
from tapnet_tpu_torch.utils import sampling


def posemb_sincos_2d(h: int, w: int, width: int, temperature: float = 10_000.0,
                     dtype=torch.float32) -> torch.Tensor:
  """MoCo-v3-style fixed 2D sin/cos position embedding: [1, h*w, width]."""
  if width % 4 != 0:
    raise ValueError("Width must be a multiple of 4 for sincos posemb.")
  y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
  omega = torch.arange(width // 4, dtype=torch.float32) / (width // 4 - 1)
  omega = 1.0 / torch.pow(torch.tensor(temperature, dtype=torch.float32), omega)
  y = torch.einsum("m,d->md", y.flatten().float(), omega)
  x = torch.einsum("m,d->md", x.flatten().float(), omega)
  pe = torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)], 1)
  return pe.to(dtype)[None]


class LayerNorm(nn.Module):
  """Holds a Flax LayerNorm's `scale` and `bias` (Flax's eps 1e-6; float32
  statistics by E[x^2] - E[x]^2), output in `dtype` if given."""

  def __init__(self, width: int, eps: float = 1e-6, dtype=None):
    super().__init__()
    self.eps = eps
    self.dtype = dtype
    self.scale = nn.Parameter(torch.ones(width))
    self.bias = nn.Parameter(torch.zeros(width))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return mixer_math.layer_norm(x, self.scale, self.bias, self.eps,
                                 self.dtype)


class MlpBlock(nn.Module):
  """Transformer MLP: Dense_0 -> GELU -> Dense_1, products in dtype_mm."""

  def __init__(self, width: int, mlp_dim: Optional[int] = None,
               dtype_mm=torch.float32):
    super().__init__()
    self.dtype_mm = dtype_mm
    self.Dense_0 = nn.Linear(width, mlp_dim or 4 * width)
    self.Dense_1 = nn.Linear(mlp_dim or 4 * width, width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = gelu(linear(x, self.Dense_0, self.dtype_mm))
    return linear(x, self.Dense_1, self.dtype_mm)


class MultiHeadDotProductAttention(nn.Module):
  """Flax MultiHeadDotProductAttention (self-attention): `query`, `key`,
  `value` Linear(D, heads*head_dim) and `out` Linear(heads*head_dim, D),
  regrouped from Flax's [D, heads, head_dim] and [heads, head_dim, D]."""

  def __init__(self, width: int, num_heads: int, dtype=torch.float32):
    super().__init__()
    self.num_heads = num_heads
    self.dtype = dtype
    self.query = nn.Linear(width, width)
    self.key = nn.Linear(width, width)
    self.value = nn.Linear(width, width)
    self.out = nn.Linear(width, width)
    head_dim = width // num_heads
    # jnp.sqrt(depth) in float32, cast to the compute dtype.
    self.sqrt_depth = float(
        torch.tensor(float(head_dim), device="cpu").sqrt().to(dtype).float())

  def forward(self, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, n, _ = x.shape
    split = lambda t: t.view(b, n, self.num_heads, -1).transpose(1, 2)
    q = split(linear(x, self.query, self.dtype))
    k = split(linear(x, self.key, self.dtype))
    v = split(linear(x, self.value, self.dtype))
    q = q / self.sqrt_depth
    bias = None
    if mask is not None:
      bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
      bias = bias.masked_fill(~mask, torch.finfo(q.dtype).min)
    y = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
    y = y.transpose(1, 2).reshape(b, n, -1)
    return linear(y, self.out, self.dtype)


class ViTBlock(nn.Module):
  """Pre-norm MHSA + MLP block over the token axis."""

  def __init__(self, width: int, num_heads: int = 12,
               mlp_dim: Optional[int] = None, dtype_mm=torch.float32,
               mask_image2image: bool = False, mask_query2image: bool = False,
               num_image_tokens: int = 1024):
    super().__init__()
    self.mask_image2image = mask_image2image
    self.mask_query2image = mask_query2image
    self.num_image_tokens = num_image_tokens
    self.LayerNorm_0 = LayerNorm(width)
    self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
        width, num_heads, dtype_mm)
    self.LayerNorm_1 = LayerNorm(width)
    self.MlpBlock_0 = MlpBlock(width, mlp_dim, dtype_mm)

  def attention_mask(self, n: int, device) -> Optional[torch.Tensor]:
    """[n, n] bool, True = attend, or None without masks."""
    if not (self.mask_image2image or self.mask_query2image):
      return None
    m = torch.ones((n, n), dtype=torch.bool, device=device)
    ni = self.num_image_tokens
    if self.mask_image2image:
      m[:ni, :ni] = False
    if self.mask_query2image:
      m[:ni, ni:] = False
    return m

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    y = self.LayerNorm_0(x)
    y = self.MultiHeadDotProductAttention_0(
        y, self.attention_mask(x.shape[1], x.device))
    x = x + y
    y = self.MlpBlock_0(self.LayerNorm_1(x))
    x = x + y
    return x, {"+mlp": x}


def _flip_time(h: torch.Tensor, sp) -> torch.Tensor:
  """[b*n, t, c] reversed in (global) time: under `sp`, the reverse of the
  mirror rank's part."""
  if sp is None:
    return torch.flip(h, dims=(1,))
  mesh, axis = sp
  parts = mesh.all_gather(h, axis)
  return torch.flip(parts[mesh.size(axis) - 1 - mesh.index(axis)], dims=(1,))


class ViTSSMBlock(nn.Module):
  """Griffin recurrence over time, then ViT attention over tokens."""

  def __init__(self, width: int, num_heads: int = 12,
               mlp_dim: Optional[int] = None, dtype_mm=torch.float32,
               lru_width: Optional[int] = None, bidirectional_ssm: bool = False,
               mask_image2image: bool = False, mask_query2image: bool = False,
               num_image_tokens: int = 1024):
    super().__init__()
    self.bidirectional_ssm = bidirectional_ssm
    # The bidirectional block runs on [forward, time-reversed] tubes
    # concatenated along channels.
    ssm_width = 2 * width if bidirectional_ssm else width
    self.ssm_block = rglru.GriffinResidualBlock(
        ssm_width, mlp_expanded_width=mlp_dim or 4 * width,
        num_heads=num_heads, lru_width=lru_width)
    self.vit_block = ViTBlock(
        width, num_heads, mlp_dim, dtype_mm, mask_image2image,
        mask_query2image, num_image_tokens)

  def forward(self, x: torch.Tensor,
              cache: Optional[rglru.RecurrentBlockCache], batch: int,
              sp=None):
    """x [b*t, n, c]: with `sp` (a (Mesh, time axis) pair) this rank's
    part of the frames."""
    bt, n, c = x.shape
    b = batch
    t = bt // b
    outs: Dict[str, Any] = {}
    # [b*t, n, c] -> [b*n, t, c]: tubes along batch, time as sequence.
    h = x.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
    if self.bidirectional_ssm:
      h2 = torch.cat([h, _flip_time(h, sp)], dim=-1)
      h2, _ = self.ssm_block(h2, None, sp)
      fwd, bwd = torch.split(h2, c, dim=-1)
      h = fwd + _flip_time(bwd, sp)
      outs["ssm_block_cache"] = None
    else:
      h, outs["ssm_block_cache"] = self.ssm_block(h, cache, sp)
    x = h.reshape(b, n, t, c).transpose(1, 2).reshape(bt, n, c)
    x, outs["vit_block_intermediates"] = self.vit_block(x)
    return x, outs


class ViTSSMBackbone(nn.Module):
  """Stack of ViTSSM blocks + final LayerNorm (the "Transformer" scope)."""

  def __init__(self, depth: int, width: int, num_heads: int = 12,
               mlp_dim: Optional[int] = None, dtype_mm=torch.float32,
               lru_width: Optional[int] = None, bidirectional_ssm: bool = False,
               mask_image2image: bool = False, mask_query2image: bool = False,
               num_image_tokens: int = 1024, remat: bool = False):
    super().__init__()
    self.depth = depth
    self.remat = remat
    for lyr in range(depth):
      self.add_module(f"encoderblock_{lyr}", ViTSSMBlock(
          width, num_heads, mlp_dim, dtype_mm, lru_width, bidirectional_ssm,
          mask_image2image, mask_query2image, num_image_tokens))
    self.encoder_norm = LayerNorm(width, dtype=dtype_mm)

  def forward(self, x: torch.Tensor,
              cache: Optional[rglru.RecurrentBlockCache] = None,
              intermediates: bool = True, sp=None):
    """x [b, t, n, c] (under `sp` this rank's part of the frames); cache:
    stacked per-layer caches [L, ...] or None.
    Returns (normed [b*t, n, c], out); out holds the stacked new caches
    ("ssm_block_cache", unless bidirectional), the pre-norm output and, with
    `intermediates`, each layer's outputs under "blockNN"."""
    out: Dict[str, Any] = {}
    b, t, n, c = x.shape
    x = x.reshape(b * t, n, c)
    layer_caches = []
    for lyr in range(self.depth):
      current = None
      if cache is not None:
        current = rglru.RecurrentBlockCache(
            cache.rg_lru_state[lyr], cache.conv1d_state[lyr])
      block = getattr(self, f"encoderblock_{lyr}")
      if self.remat and torch.is_grad_enabled():
        x, outs = torch.utils.checkpoint.checkpoint(
            block, x, current, b, sp, use_reentrant=False)
      else:
        x, outs = block(x, current, b, sp)
      if intermediates:
        out[f"block{lyr:02d}"] = outs
      layer_caches.append(outs["ssm_block_cache"])
    if layer_caches[0] is not None:
      out["ssm_block_cache"] = rglru.RecurrentBlockCache(
          torch.stack([lc.rg_lru_state for lc in layer_caches]),
          torch.stack([lc.conv1d_state for lc in layer_caches]))
    out["pre_ln"] = x
    return self.encoder_norm(x), out


@dataclasses.dataclass
class TAPNextTrackingState:
  """Streaming state of online TAPNext."""

  step: int
  query_points: torch.Tensor  # [B, Q, (hints,) 3] (t, y, x)
  query_padding: torch.Tensor  # [B, Q, (hints)]
  hidden_state: Optional[rglru.RecurrentBlockCache] = None  # stacked [L, ...]


@dataclasses.dataclass(frozen=True)
class SsmVitConfig:
  """Architecture config, as the JAX package's."""

  width: int = 768
  depth: int = 12
  mlp_dim: int = 3072
  num_heads: int = 12
  patch_size: Tuple[int, int, int] = (1, 8, 8)
  image_size: Tuple[int, int] = (256, 256)
  lru_width: Optional[int] = None
  posemb: str = "learn"
  posemb_full: str = "learn"
  bidirectional_ssm: bool = False
  query_scale: int = 1
  mask_image2image: bool = False
  mask_query2image: bool = False
  # "bfloat16" runs attention and MLP products in bf16 (parameters stay
  # float32; the RG-LRU recurrence, the SSM block, norms and heads stay
  # float32).
  compute_dtype: str = "float32"
  # Recompute each ViT-SSM block in the backward (its input stored, its
  # internals recomputed); changes memory, not numbers.
  remat: bool = False
  # Sequence parallelism: a parallel.mesh.Mesh whose `sp_axis` axis splits
  # the time axis of the offline forward (module docstring); None: off.
  sp_mesh: Optional[Any] = None
  sp_axis: str = "data"

  @property
  def dtype_mm(self):
    return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


VARIANTS = {
    "mu": dict(width=32, depth=1, mlp_dim=128, num_heads=2),
    "Ti": dict(width=192, depth=12, mlp_dim=768, num_heads=3),
    "S": dict(width=384, depth=12, mlp_dim=1536, num_heads=6),
    "M": dict(width=512, depth=12, mlp_dim=2048, num_heads=8),
    "B": dict(width=768, depth=12, mlp_dim=3072, num_heads=12),
    "L": dict(width=1024, depth=24, mlp_dim=4096, num_heads=16),
    "H": dict(width=1280, depth=32, mlp_dim=5120, num_heads=16),
}


def variant_config(variant: str, **overrides) -> SsmVitConfig:
  kwargs = dict(VARIANTS[variant])
  kwargs.update(overrides)
  return SsmVitConfig(**kwargs)


def draw_cutoffs(generator: torch.Generator, batch: int,
                 num_frames: int) -> torch.Tensor:
  """[batch] cutoffs s, each uniform over {1, ..., num_frames - 1}, drawn
  from `generator` on its device."""
  return torch.randint(1, num_frames, (batch,), generator=generator,
                       device=generator.device)


def mask_suffix(tokens: torch.Tensor, mask_token: torch.Tensor,
                cutoff: torch.Tensor):
  """(tokens with those at frames t >= cutoff[b] replaced by `mask_token`,
  masked [B, T] bool) for tokens [B, T, N, D] and a mask token that
  broadcasts to them."""
  t = tokens.shape[1]
  masked = (torch.arange(t, device=tokens.device)[None]
            >= cutoff.to(tokens.device)[:, None])
  tokens = torch.where(masked[:, :, None, None],
                       mask_token.to(tokens.dtype).expand_as(tokens), tokens)
  return tokens, masked


class TokenSubsampling(nn.Module):
  """Random temporal-suffix masking of video tokens (drops video tubes): per
  batch element a cutoff s ~ Uniform{1, ..., T-1} (`draw_cutoffs`), and
  every token at frames t >= s becomes the mask token (`mask_suffix`), so
  the model learns to keep tracking when observations stop.

  The drop ratio only switches it on or off, as in the JAX package:
  `override_drop_ratio` when given, else `drop_ratio` with `is_training`
  and `drop_ratio_test` without. At 0 the tokens come back unchanged with
  an all-False mask. Returns (tokens, masked [B, T] bool, True = masked)."""

  def __init__(self, drop_ratio: float, drop_ratio_test: float = 0.0,
               is_training: bool = False):
    super().__init__()
    self.drop_ratio = drop_ratio
    self.drop_ratio_test = drop_ratio_test
    self.is_training = is_training

  def forward(self, tokens: torch.Tensor, mask_token: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              override_drop_ratio: Optional[float] = None):
    b, t = tokens.shape[:2]
    if override_drop_ratio is not None:
      drop_ratio = override_drop_ratio
    elif self.is_training:
      drop_ratio = self.drop_ratio
    else:
      drop_ratio = self.drop_ratio_test
    if drop_ratio == 0.0:
      return tokens, torch.zeros((b, t), dtype=torch.bool,
                                 device=tokens.device)
    if generator is None:
      raise ValueError("TokenSubsampling needs a generator to draw cutoffs.")
    return mask_suffix(tokens, mask_token, draw_cutoffs(generator, b, t))


class _PatchEmbed(nn.Module):
  """Patch embedding as reshape + matmul: the non-overlapping patch conv,
  `weight` [D, ph*pw*3] (Flax kernel [1, ph, pw, 3, D]) and `bias` [D]."""

  def __init__(self, width: int, patch_size: Tuple[int, int, int],
               in_channels: int = 3):
    super().__init__()
    pt, ph, pw = patch_size
    if pt != 1:
      raise NotImplementedError(
          "temporal patching (patch_size[0] != 1) is not supported; got "
          f"patch_size={patch_size}")
    self.patch_size = patch_size
    self.weight = nn.Parameter(torch.zeros(width, ph * pw * in_channels))
    self.bias = nn.Parameter(torch.zeros(width))

  def forward(self, video: torch.Tensor) -> torch.Tensor:
    _, ph, pw = self.patch_size
    b, t, h, w, cin = video.shape
    x = video.reshape(b, t, h // ph, ph, w // pw, pw, cin)
    x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(
        b, t, h // ph, w // pw, ph * pw * cin)
    return linear(x, self)


class MaskedSequenceDecoder(nn.Module):
  """TAPNext backbone: patch embed + query tokens + ViT-SSM encoder."""

  def __init__(self, config: SsmVitConfig = SsmVitConfig()):
    super().__init__()
    cfg = self.config = config
    self.embedding = _PatchEmbed(cfg.width, cfg.patch_size)
    h = cfg.image_size[0] // cfg.patch_size[1]
    w = cfg.image_size[1] // cfg.patch_size[2]
    self.grid_hw = (h, w)
    self.Transformer = ViTSSMBackbone(
        depth=cfg.depth, width=cfg.width, num_heads=cfg.num_heads,
        mlp_dim=cfg.mlp_dim, dtype_mm=cfg.dtype_mm, lru_width=cfg.lru_width,
        bidirectional_ssm=cfg.bidirectional_ssm,
        mask_image2image=cfg.mask_image2image,
        mask_query2image=cfg.mask_query2image, num_image_tokens=h * w,
        remat=cfg.remat)
    c = cfg.width
    self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, c))
    self.unknown_token = nn.Parameter(torch.zeros(1, 1, c))
    self.point_query_token = nn.Parameter(torch.zeros(1, 1, 1, c))
    if cfg.posemb == "learn":
      self.pos_embedding = nn.Parameter(torch.zeros(1, h * w, c))
    if cfg.posemb_full == "learn":
      ph, pw = cfg.image_size
      self.pos_embedding_full = nn.Parameter(
          torch.zeros(1, ph * pw * cfg.query_scale**2, c))

  def _posemb_image(self) -> torch.Tensor:
    if self.config.posemb == "learn":
      return self.pos_embedding
    return posemb_sincos_2d(*self.grid_hw, self.config.width).to(
        self.mask_token.device)

  def _posemb_full_spatial(self) -> torch.Tensor:
    cfg = self.config
    ph = cfg.image_size[0] * cfg.query_scale
    pw = cfg.image_size[1] * cfg.query_scale
    if cfg.posemb_full == "learn":
      pe = self.pos_embedding_full
    else:
      pe = posemb_sincos_2d(ph, pw, cfg.width).to(self.mask_token.device)
    return pe.reshape(ph, pw, cfg.width)

  def embed_queries_and_hints(
      self,
      timesteps: int,
      query_points: torch.Tensor,  # [B, Q, hints, 3] (t, y, x)
      query_padding: torch.Tensor,  # [B, Q, hints]
  ) -> torch.Tensor:  # [B, T, Q, c]
    """Query tokens: per track and frame its [XY] token (query token + the
    full-resolution position embedding sampled at the point) on hint frames,
    [U] (unknown) before the first hint and [M] (mask: predict here)
    elsewhere. Later hints override earlier ones."""
    cfg = self.config
    b, q, hints, _ = query_points.shape
    t = timesteps
    ts = query_points[..., 0].to(torch.int32)  # truncates, as astype(int32)
    positions = query_points[..., 1:]  # (y, x)
    padding = query_padding.to(torch.bool)

    pe_full = self._posemb_full_spatial()
    pos_flat = (positions * cfg.query_scale).reshape(b, q * hints, 2)
    pe_samples = sampling.sample_grid_2d(pe_full, pos_flat, mode="nearest")
    xy_tokens = self.point_query_token + pe_samples.reshape(
        b, q, hints, cfg.width)

    t_idx = torch.arange(t, device=query_points.device)[None, :, None]
    tokens = self.mask_token.expand(b, t, q, cfg.width)
    # [U] prefix before the first hint.
    prefix = torch.clamp(ts[..., 0], 0, t)  # [B, Q]
    unknown_sel = (t_idx < prefix[:, None, :]) & padding[..., 0][:, None, :]
    tokens = torch.where(unknown_sel[..., None],
                         self.unknown_token[:, :, None, :], tokens)
    # [XY] tokens, in hint order.
    for k in range(hints):
      ts_k = ts[..., k]
      valid = padding[..., k] & (ts_k >= 0) & (ts_k < t)
      ts_c = torch.clamp(ts_k, 0, t - 1)
      sel = (t_idx == ts_c[:, None, :]) & valid[:, None, :]
      tokens = torch.where(sel[..., None], xy_tokens[:, None, :, k, :], tokens)
    return tokens

  def sp_for(self, t: int):
    """The (Mesh, axis) pair when a clip of t frames runs time-split (see
    `rglru.sp_active`), else None."""
    cfg = self.config
    sp = None if cfg.sp_mesh is None else (cfg.sp_mesh, cfg.sp_axis)
    return sp if rglru.sp_active(sp, t) else None

  def _local_frames(self, video, sp):
    """(this rank's frames, their first global index)."""
    if sp is None:
      return video, 0
    mesh, axis = sp
    part = sequence.shard_time(video, mesh, axis)
    return part, mesh.index(axis) * part.shape[1]

  def _encode(self, video, query_tokens, cache, intermediates, sp=None):
    """Patchify + posemb + concat query tokens + run the encoder."""
    x = self.embedding(video)
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h * w, c) + self._posemb_image()[:, None]
    x = torch.cat([x, query_tokens.to(x.dtype)], dim=2)
    x, out = self.Transformer(x, cache, intermediates, sp)
    return x.reshape(b, t, -1, c), out, (h, w)

  @staticmethod
  def _shift_times(query_points, offset):
    """Query times relative to a clip that starts at global frame
    `offset`."""
    if not offset:
      return query_points
    return torch.cat([query_points[..., :1] - offset, query_points[..., 1:]],
                     dim=-1)

  @staticmethod
  def _with_hints(query_points, query_padding):
    if query_points.ndim == 3:
      query_points = query_points[..., None, :]
    if query_padding is None:
      query_padding = torch.ones(query_points.shape[:-1], dtype=torch.bool,
                                 device=query_points.device)
    elif query_padding.ndim == 2:
      query_padding = query_padding[..., None]
    return query_points, query_padding

  def forward(self, video, query_points, query_padding=None,
              intermediates: bool = True):
    """Offline forward. video [B, T, H, W, 3]; query_points [B, Q, (hints,)
    3] (t, y, x). Returns (video_feats [B, T, h, w, c], query_feats
    [B, T, Q, c], out with the per-layer outputs if `intermediates`); under
    sequence parallelism (`sp_for`) T is this rank's part of the frames."""
    sp = self.sp_for(video.shape[1])
    video, offset = self._local_frames(video, sp)
    query_points, query_padding = self._with_hints(query_points, query_padding)
    q = query_points.shape[1]
    query_tokens = self.embed_queries_and_hints(
        video.shape[1], self._shift_times(query_points, offset), query_padding)
    x, out, (h, w) = self._encode(video, query_tokens, None, intermediates,
                                  sp)
    video_feats = x[:, :, : h * w].reshape(x.shape[0], x.shape[1], h, w,
                                           x.shape[-1])
    return video_feats, x[:, :, -q:], out

  def forward_step(self, video: torch.Tensor, state: TAPNextTrackingState):
    """Streaming step over video [B, T, H, W, 3] (usually T = 1) with the
    per-layer recurrent caches of `state`; returns (query_feats, new state).
    Under sequence parallelism (`sp_for`) the features are of this rank's
    part of the frames."""
    if state.hidden_state is None:
      raise ValueError("state.hidden_state is required for forward_step.")
    t = video.shape[1]
    sp = self.sp_for(t)
    video, offset = self._local_frames(video, sp)
    query_points, query_padding = self._with_hints(
        state.query_points, state.query_padding)
    # Shift query times into this chunk's (and rank's) local frame.
    query_points = self._shift_times(query_points, state.step + offset)
    q = query_points.shape[1]
    query_tokens = self.embed_queries_and_hints(
        video.shape[1], query_points, query_padding)
    x, out, _ = self._encode(video, query_tokens, state.hidden_state, False,
                             sp)
    new_state = TAPNextTrackingState(
        step=state.step + t, query_points=state.query_points,
        query_padding=state.query_padding,
        hidden_state=out["ssm_block_cache"])
    return x[:, :, -q:], new_state
