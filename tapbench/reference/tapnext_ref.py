"""Plain float32 TAPNext: the benchmark's reference.

A frozen copy of the plain PyTorch paths of the port's TAPNext
(`tapnet_tpu_torch/models/{tapnext,ssm_vit,rglru}.py`, the plain linear
scan of `ops/scan.py`, `utils/sampling.py`), reduced to the float32
forward: learned position embeddings, one hint per query, no
bidirectional SSM, no masks, no ranks, no training. Attention is written
out (scores, softmax, weighted sum). It imports nothing of the program (nor
JAX) and builds its own modules from the Flax parameter tree that the
benchmark makes, converting it itself.

A clip runs in time chunks with the recurrent state carried from one to
the next (`forward_chunk`): the recurrence is exact and attention is per
frame, so the chunks give the one-pass function, in as little memory as a
chunk takes. The caller turns TF32 off.

`vit_precision="fp8"` is the control: the ViT blocks' products (q, k, v,
out, the MLP) take float8 e4m3 operands, the activations scaled per row and
the weights per output column, the step below the configuration's bfloat16
for those products; everything else stays float32.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ATTENTION_INPUTS = ("query", "key", "value")
_FP8_MAX = 448.0


def _walk(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _walk(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
  """The Flax TAPNext tree (numpy leaves) as this module's state dict."""
  out = {}
  for path, value in _walk(params):
    arr = np.asarray(value, dtype=np.float32)
    leaf, module = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
      if module in _ATTENTION_INPUTS and arr.ndim == 3:
        arr = arr.reshape(arr.shape[0], -1).T
      elif module == "out" and arr.ndim == 3:
        arr = arr.reshape(-1, arr.shape[-1]).T
      elif module == "embedding" and arr.ndim == 5:
        arr = arr.reshape(-1, arr.shape[-1]).T
      else:
        arr = arr.T
      leaf = "weight"
    elif leaf == "bias" and module in _ATTENTION_INPUTS and arr.ndim == 2:
      arr = arr.reshape(-1)
    out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
        np.ascontiguousarray(arr))
  return out


def gelu(x):
  return F.gelu(x, approximate="tanh")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
  """x rounded to float8 e4m3 on a scale per slice along `dim` (amax to
  the format's largest value), back in float32."""
  scale = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-12) / _FP8_MAX
  return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _linear(x, layer, fp8=False):
  w = layer.weight
  if fp8:
    x, w = _fp8(x, -1), _fp8(w, -1)
  return F.linear(x, w, layer.bias)


class LayerNorm(nn.Module):
  def __init__(self, width, eps=1e-6):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(width))
    self.bias = nn.Parameter(torch.zeros(width))

  def forward(self, x):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class _Dense2(nn.Module):
  def __init__(self, width, mlp):
    super().__init__()
    self.Dense_0 = nn.Linear(width, mlp)
    self.Dense_1 = nn.Linear(mlp, width)


class _Attention(nn.Module):
  def __init__(self, width, heads):
    super().__init__()
    self.heads = heads
    self.query = nn.Linear(width, width)
    self.key = nn.Linear(width, width)
    self.value = nn.Linear(width, width)
    self.out = nn.Linear(width, width)

  def forward(self, x, fp8):
    b, n, d = x.shape
    split = lambda t: t.view(b, n, self.heads, -1).transpose(1, 2)
    q = split(_linear(x, self.query, fp8))
    k = split(_linear(x, self.key, fp8))
    v = split(_linear(x, self.value, fp8))
    q = q / float(np.sqrt(np.float32(d // self.heads)))
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    y = (w @ v).transpose(1, 2).reshape(b, n, d)
    return _linear(y, self.out, fp8)


class ViTBlock(nn.Module):
  def __init__(self, width, heads, mlp):
    super().__init__()
    self.LayerNorm_0 = LayerNorm(width)
    self.MultiHeadDotProductAttention_0 = _Attention(width, heads)
    self.LayerNorm_1 = LayerNorm(width)
    self.MlpBlock_0 = _Dense2(width, mlp)

  def forward(self, x, fp8):
    x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), fp8)
    m = self.MlpBlock_0
    y = _linear(gelu(_linear(self.LayerNorm_1(x), m.Dense_0, fp8)), m.Dense_1, fp8)
    return x + y


class RMSNorm(nn.Module):
  def __init__(self, width, eps=1e-6):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.zeros(width))

  def forward(self, x):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + self.eps) * (self.scale + 1)


class _BlockDiag(nn.Module):
  def __init__(self, width, heads):
    super().__init__()
    self.heads = heads
    self.w = nn.Parameter(torch.empty(heads, width // heads, width // heads))
    self.b = nn.Parameter(torch.zeros(heads, width // heads))

  def forward(self, x):
    xb = x.reshape(x.shape[:-1] + (self.heads, -1))
    return (torch.einsum("...hi,hij->...hj", xb, self.w) + self.b).reshape(x.shape)


class _RGLRU(nn.Module):
  def __init__(self, width, heads):
    super().__init__()
    self.a_param = nn.Parameter(torch.empty(width))
    self.input_gate = _BlockDiag(width, heads)
    self.a_gate = _BlockDiag(width, heads)

  def forward(self, x, h0):
    """x [B, T, C]; h0 [B, C] or None (a fresh sequence) -> (y, h_last)."""
    gate_x = torch.sigmoid(self.input_gate(x))
    gate_a = torch.sigmoid(self.a_gate(x))
    log_a = -8.0 * gate_a * F.softplus(self.a_param)
    a = torch.exp(log_a)
    mult = torch.sqrt(1 - torch.exp(2 * log_a))
    if h0 is None:
      first = torch.arange(x.shape[1], device=x.device)[None, :, None] == 0
      mult = torch.where(first, 1.0, mult)
      h0 = torch.zeros(x.shape[0], x.shape[2], device=x.device)
    xs = x * gate_x * mult
    h, ys = h0, []
    for t in range(x.shape[1]):
      h = a[:, t] * h + xs[:, t]
      ys.append(h)
    return torch.stack(ys, 1), h


class _Conv1D(nn.Module):
  def __init__(self, width, k=4):
    super().__init__()
    self.w = nn.Parameter(torch.empty(k, width))
    self.b = nn.Parameter(torch.zeros(width))

  def forward(self, x, cache):
    k = self.w.shape[0]
    if cache is None:
      cache = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    full = torch.cat([cache, x], 1)
    t = x.shape[1]
    y = self.b + sum(full[:, j:j + t] * self.w[j] for j in range(k))
    return y, full[:, full.shape[1] - (k - 1):]


class _Recurrent(nn.Module):
  def __init__(self, width, heads):
    super().__init__()
    self.linear_y = nn.Linear(width, width)
    self.linear_x = nn.Linear(width, width)
    self.conv_1d = _Conv1D(width)
    self.rg_lru = _RGLRU(width, heads)
    self.linear_out = nn.Linear(width, width)


class _FfwUp(nn.Module):
  def __init__(self, width, mlp):
    super().__init__()
    self.w = nn.Parameter(torch.empty(2, width, mlp))
    self.b = nn.Parameter(torch.zeros(2, 1, 1, mlp))


class _GriffinMlp(nn.Module):
  def __init__(self, width, mlp):
    super().__init__()
    self.ffw_up = _FfwUp(width, mlp)
    self.ffw_down = nn.Linear(mlp, width)


class SSMBlock(nn.Module):
  def __init__(self, width, heads, mlp):
    super().__init__()
    self.temporal_pre_norm = RMSNorm(width)
    self.recurrent_block = _Recurrent(width, heads)
    self.channel_pre_norm = RMSNorm(width)
    self.mlp_block = _GriffinMlp(width, mlp)

  def forward(self, x, cache):
    """x [B*N, T, C]; cache (lru [B*N, C], conv [B*N, 3, C]) or None."""
    r = self.recurrent_block
    h = self.temporal_pre_norm(x)
    y = gelu(F.linear(h, r.linear_y.weight, r.linear_y.bias))
    h = F.linear(h, r.linear_x.weight, r.linear_x.bias)
    h, conv = r.conv_1d(h, None if cache is None else cache[1])
    h, lru = r.rg_lru(h, None if cache is None else cache[0])
    x = x + F.linear(h * y, r.linear_out.weight, r.linear_out.bias)
    m = self.mlp_block
    h = self.channel_pre_norm(x)
    up = torch.einsum("...td,cdD->c...tD", h, m.ffw_up.w) + m.ffw_up.b
    x = x + F.linear(gelu(up[0]) * up[1], m.ffw_down.weight, m.ffw_down.bias)
    return x, (lru, conv)


class _Layer(nn.Module):
  def __init__(self, width, heads, mlp):
    super().__init__()
    self.ssm_block = SSMBlock(width, heads, mlp)
    self.vit_block = ViTBlock(width, heads, mlp)


class _Transformer(nn.Module):
  def __init__(self, cfg):
    super().__init__()
    self.depth = cfg["depth"]
    for i in range(self.depth):
      self.add_module(f"encoderblock_{i}", _Layer(
          cfg["width"], cfg["num_heads"], cfg["mlp_dim"]))
    self.encoder_norm = LayerNorm(cfg["width"])


class _Embedding(nn.Module):
  def __init__(self, width, ph, pw):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(width, ph * pw * 3))
    self.bias = nn.Parameter(torch.zeros(width))


class _Backbone(nn.Module):
  def __init__(self, cfg):
    super().__init__()
    c = cfg["width"]
    _, ph, pw = cfg["patch_size"]
    h, w = cfg["image_size"]
    self.embedding = _Embedding(c, ph, pw)
    self.Transformer = _Transformer(cfg)
    self.mask_token = nn.Parameter(torch.empty(1, 1, 1, c))
    self.unknown_token = nn.Parameter(torch.empty(1, 1, c))
    self.point_query_token = nn.Parameter(torch.empty(1, 1, 1, c))
    self.pos_embedding = nn.Parameter(torch.empty(1, (h // ph) * (w // pw), c))
    self.pos_embedding_full = nn.Parameter(torch.empty(1, h * w, c))


class _Head(nn.Module):
  def __init__(self, width, out, inner=256):
    super().__init__()
    self.layers_0 = nn.Linear(width, inner)
    self.layers_1 = LayerNorm(inner)
    self.layers_3 = nn.Linear(inner, inner)
    self.layers_4 = LayerNorm(inner)
    self.layers_6 = nn.Linear(inner, out)

  def forward(self, x):
    x = gelu(self.layers_1(F.linear(x, self.layers_0.weight, self.layers_0.bias)))
    x = gelu(self.layers_4(F.linear(x, self.layers_3.weight, self.layers_3.bias)))
    return F.linear(x, self.layers_6.weight, self.layers_6.bias)


def _sample_nearest(grid, yx):
  """Bilinear sampling (clamped corners) of grid [H, W, C] at raster
  points yx [..., 2]."""
  h, w, c = grid.shape
  y, x = yx[..., 0] - 0.5, yx[..., 1] - 0.5
  y0, x0 = torch.floor(y), torch.floor(x)
  fy, fx = y - y0, x - x0
  y0, x0 = y0.long(), x0.long()
  flat = grid.reshape(h * w, c)
  out = 0.0
  for dy, wy in ((0, 1 - fy), (1, fy)):
    for dx, wx in ((0, 1 - fx), (1, fx)):
      idx = (y0 + dy).clamp(0, h - 1) * w + (x0 + dx).clamp(0, w - 1)
      out = out + flat[idx] * (wy * wx)[..., None]
  return out


class TAPNext(nn.Module):
  """TAPNext with the configuration's fields (a `configs/*.json` "model"
  object)."""

  def __init__(self, cfg: Mapping):
    super().__init__()
    self.cfg = dict(cfg)
    self.backbone = _Backbone(cfg)
    self.visible_head = _Head(cfg["width"], 1)
    self.coordinate_head = _Head(cfg["width"], 512)
    self.vit_fp8 = False

  def _query_tokens(self, t: int, step: int, qp):
    """[B, T, Q, C] query tokens of frames step .. step + t - 1: [XY] at
    the query frame, [U] before it, [M] after."""
    bb = self.backbone
    c = self.cfg["width"]
    h, w = self.cfg["image_size"]
    b, q, _ = qp.shape
    ts = (qp[..., 0] - step).to(torch.int32)
    xy = bb.point_query_token[:, :, 0] + _sample_nearest(
        bb.pos_embedding_full.reshape(h, w, c), qp[..., 1:])
    t_idx = torch.arange(t, device=qp.device)[None, :, None]
    tokens = bb.mask_token.expand(b, t, q, c)
    prefix = torch.clamp(ts, 0, t)
    tokens = torch.where((t_idx < prefix[:, None, :])[..., None],
                         bb.unknown_token[:, :, None, :], tokens)
    valid = (ts >= 0) & (ts < t)
    sel = (t_idx == torch.clamp(ts, 0, t - 1)[:, None, :]) & valid[:, None, :]
    return torch.where(sel[..., None], xy[:, None], tokens)

  def forward_chunk(self, video, qp, step: int, state: Optional[List]):
    """Frames step .. step + T - 1 of the clip, video [B, T, H, W, 3];
    query points qp [B, Q, 3] (t, y, x) in clip frames; state: each layer's
    (lru, conv) cache, None at the clip's start. Returns ((y, x) tracks
    [B, Q, T, 2], visibility logits [B, Q, T], new state)."""
    cfg = self.cfg
    bb = self.backbone
    b, t, h, w, _ = video.shape
    _, ph, pw = cfg["patch_size"]
    c = cfg["width"]
    x = video.reshape(b, t, h // ph, ph, w // pw, pw, 3).permute(
        0, 1, 2, 4, 3, 5, 6).reshape(b, t, (h // ph) * (w // pw), ph * pw * 3)
    x = F.linear(x, bb.embedding.weight, bb.embedding.bias) + bb.pos_embedding[:, None]
    x = torch.cat([x, self._query_tokens(t, step, qp)], 2)
    n = x.shape[2]
    x = x.reshape(b * t, n, c)
    new_state = []
    for i in range(cfg["depth"]):
      layer = getattr(bb.Transformer, f"encoderblock_{i}")
      tubes = x.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
      tubes, cache = layer.ssm_block(tubes, None if state is None else state[i])
      new_state.append(cache)
      x = tubes.reshape(b, n, t, c).transpose(1, 2).reshape(b * t, n, c)
      x = layer.vit_block(x, self.vit_fp8)
    x = bb.Transformer.encoder_norm(x)
    q = qp.shape[1]
    feats = x.reshape(b, t, n, c)[:, :, -q:]
    position = self.coordinate_head(feats)
    visible = self.visible_head(feats)[..., 0]
    c0, c1 = torch.split(position, position.shape[-1] // 2, dim=-1)
    tracks = torch.cat([self._decode(c0), self._decode(c1)], -1) + 0.5
    return tracks.transpose(1, 2), visible.transpose(1, 2), new_state

  @staticmethod
  def _decode(logits, threshold=20, temperature=0.5):
    idx = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    peak = torch.argmax(logits, dim=-1, keepdim=True)
    mask = (torch.abs(peak - idx) <= threshold).float()
    probs = torch.softmax(logits * temperature, dim=-1) * mask
    probs = probs / probs.sum(-1, keepdim=True)
    return (probs * idx).sum(-1)[..., None]


def build(cfg: Mapping, params: Mapping, device) -> TAPNext:
  """The reference model on `device` with the tree's weights (strict)."""
  model = TAPNext(cfg)
  model.load_state_dict(state_dict(params), strict=True)
  return model.to(device).eval()


@torch.no_grad()
def track(model: TAPNext, video, query_points, chunk: int,
          vit_precision: str = "float32") -> Tuple[torch.Tensor, torch.Tensor]:
  """(tracks [B, Q, T, 2] (x, y), occlusion logits [B, Q, T]) of a whole
  clip, `chunk` frames at a time with the state carried."""
  model.vit_fp8 = vit_precision == "fp8"
  state, tracks, vis = None, [], []
  for s in range(0, video.shape[1], chunk):
    tr, v, state = model.forward_chunk(video[:, s:s + chunk].float(),
                                       query_points.float(), s, state)
    tracks.append(tr)
    vis.append(v)
  return torch.cat(tracks, 2).flip(-1), -torch.cat(vis, 2)
