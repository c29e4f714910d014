"""Plain float32 TAPIR / BootsTAPIR: the benchmark's reference.

A frozen copy of the plain PyTorch paths of the port's offline TAPIR
(`tapnet_tpu_torch/models/{tapir,resnet,layers}.py`, `ops/mixer_math.py`,
`ops/corr_tents.py`'s plain version, `utils/{sampling,transforms}.py`),
reduced to the float32 forward of one configuration family: no kernels, no
int8 or bfloat16 modes, no causal state, no training, no ranks. It imports
nothing of the program (nor JAX) and builds its own modules from the Flax
parameter tree that the benchmark loads, converting it itself.

Every product runs in float32; the caller turns TF32 off
(`torch.backends.{cuda.matmul,cudnn}.allow_tf32 = False`). The backbone runs
`frame_chunk` frames at a time and the refinement `query_chunk` queries at a
time, so that the reference fits beside what the run keeps: frames and
queries are independent in the offline model.
"""

from __future__ import annotations

import itertools
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-5


# ------------------------------------------------------------ weights


def _walk(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _walk(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
  """The Flax TAPIR tree (numpy leaves) as this module's state dict: conv
  kernels HWIO -> OIHW, dense kernels transposed, the rest unchanged."""
  out = {}
  for path, value in _walk(params):
    arr = np.asarray(value, dtype=np.float32)
    leaf = path[-1]
    if leaf == "kernel":
      if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
      elif arr.ndim == 2:
        arr = arr.T
      leaf = "weight"
    out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
        np.ascontiguousarray(arr))
  return out


# ------------------------------------------------------------ sampling


def convert_coords(coords, in_size, out_size):
  scale = torch.as_tensor(
      (np.asarray(out_size) / np.asarray(in_size)).astype(np.float32),
      device=coords.device)
  return coords * scale


def _corners(coord, size):
  lower = torch.floor(coord)
  frac = coord - lower
  i0 = lower.long()
  return ((i0.clamp(0, size - 1), 1.0 - frac),
          ((i0 + 1).clamp(0, size - 1), frac))


def sample_grid(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
  """Multilinear sampling ("nearest": clamped corners) of grid [B, *S, C]
  at raster points [B, ..., len(S)]; time (a leading third axis) has no
  0.5 shift."""
  b, c = grid.shape[0], grid.shape[-1]
  spatial = grid.shape[1:-1]
  nd = points.shape[-1]
  pts = points.reshape(b, -1, nd)
  shifts = (0.0,) * (nd - 2) + (0.5, 0.5)
  corners = [_corners(pts[..., d] - shifts[d], spatial[d]) for d in range(nd)]
  flat = grid.reshape(b, -1, c)
  out = None
  for combo in itertools.product(*corners):
    idx = combo[0][0]
    for d in range(1, nd):
      idx = idx * spatial[d] + combo[d][0]
    weight = combo[0][1]
    for d in range(1, nd):
      weight = weight * combo[d][1]
    vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
    term = vals.float() * weight[..., None]
    out = term if out is None else out + term
  return out.reshape(points.shape[:-1] + (c,))


def soft_argmax(heat: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
  """[..., H, W] -> [..., 2] (x, y): the heat-weighted mean of the cells
  within `threshold` of the argmax."""
  h, w = heat.shape[-2:]
  flat = heat.reshape(-1, h * w)
  dev = heat.device
  ys = torch.arange(h, device=dev, dtype=heat.dtype) + 0.5
  xs = torch.arange(w, device=dev, dtype=heat.dtype) + 0.5
  cy = ys[:, None].expand(h, w).reshape(-1)
  cx = xs[None, :].expand(h, w).reshape(-1)
  arg = torch.argmax(flat, dim=-1)
  d2 = (cy[None] - cy[arg][:, None]) ** 2 + (cx[None] - cx[arg][:, None]) ** 2
  wts = flat * (d2 < threshold**2).to(heat.dtype)
  den = torch.clamp(wts.sum(-1), min=1e-12)
  out = torch.stack([(wts * cx).sum(-1) / den, (wts * cy).sum(-1) / den], -1)
  return out.reshape(heat.shape[:-2] + (2,))


def heatmaps_to_points(heat, image_shape, query_points):
  """[B, N, T, H, W] heatmaps -> [B, N, T, 2] (x, y) at the image's size,
  the query frames' points replaced by the queries themselves."""
  pts = soft_argmax(heat)
  n, t, hh, ww = heat.shape[1:]
  pts = convert_coords(pts, (ww, hh), tuple(image_shape)[3:1:-1])
  qf = convert_coords(query_points, tuple(image_shape)[1:4], (t, hh, ww))[..., 0]
  qf = torch.round(qf).to(torch.int32)
  frames = torch.arange(image_shape[1], dtype=torch.int32, device=heat.device)
  is_q = (qf[..., None] == frames[None, None]).to(pts.dtype)[..., None]
  return pts * (1.0 - is_q) + query_points[:, :, None, [2, 1]] * is_q


def default_resolutions(full, train):
  if all(x == y for x, y in zip(train, full)):
    return [tuple(train)]
  ratio = np.array(full) / np.array(train)
  levels = int(np.ceil(np.max(np.log2(ratio))) + 1)
  if levels <= 1:
    return [tuple(train)]
  out = []
  for i in range(levels):
    f = i / (levels - 1)
    out.append((int(round((train[0] * (full[0] / train[0]) ** f) // 8)) * 8,
                int(round((train[1] * (full[1] / train[1]) ** f) // 8)) * 8))
  return out


def resize_video(video, out_hw):
  b, t, h, w, c = video.shape
  if (h, w) == tuple(out_hw):
    return video
  x = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2).float()
  x = F.interpolate(x, size=tuple(out_hw), mode="bilinear", antialias=True,
                    align_corners=False)
  return x.permute(0, 2, 3, 1).to(video.dtype).reshape(
      (b, t) + tuple(out_hw) + (c,))


# ------------------------------------------------------------ layers


def gelu(x):
  return F.gelu(x, approximate="tanh")


def _same(size, k, stride):
  out = -(-size // stride)
  total = max((out - 1) * stride + k - size, 0)
  return total // 2, total - total // 2


class Conv(nn.Module):
  def __init__(self, cin, cout, k, bias=True):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
    self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

  def forward(self, x, stride=1):
    k = self.weight.shape[2]
    top, bottom = _same(x.shape[2], k, stride)
    left, right = _same(x.shape[3], k, stride)
    w = self.weight.to(x.dtype)
    b = None if self.bias is None else self.bias.to(x.dtype)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride)


class InstanceNorm(nn.Module):
  def __init__(self, c):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(c))
    self.offset = nn.Parameter(torch.zeros(c))

  def forward(self, x):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3), unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + _EPS)
    out = out * self.scale[:, None, None] + self.offset[:, None, None]
    return out.to(x.dtype)


class Block(nn.Module):
  """ResNet v2 block: InstanceNorm -> ReLU -> 3x3 conv, twice; the 1x1
  projection taken from the first activation."""

  def __init__(self, cin, c, stride, proj):
    super().__init__()
    self.stride = stride
    self.norm_0, self.conv_0 = InstanceNorm(cin), Conv(cin, c, 3, bias=False)
    self.norm_1, self.conv_1 = InstanceNorm(c), Conv(c, c, 3, bias=False)
    self.proj_conv = Conv(cin, c, 1, bias=False) if proj else None

  def forward(self, x):
    h = torch.relu(self.norm_0(x))
    short = x if self.proj_conv is None else self.proj_conv(h, self.stride)
    h = self.conv_0(h, self.stride)
    h = self.conv_1(torch.relu(self.norm_1(h)))
    return h + short


class ResNet(nn.Module):
  def __init__(self, blocks, channels, strides=(1, 2, 2, 1)):
    super().__init__()
    self.stem_conv = Conv(3, 64, 7, bias=False)
    cin = 64
    self.names = []
    for g, (n, c, s) in enumerate(zip(blocks, channels, strides)):
      for b in range(n):
        name = f"group_{g}_block_{b}"
        self.add_module(name, Block(cin, c, s if b == 0 else 1, b == 0))
        self.names.append((g, name))
        cin = c

  def forward(self, x):
    x = self.stem_conv(x, 2)
    out = {}
    for g, name in self.names:
      x = getattr(self, name)(x)
      out[g] = x
    return out[3], out[1]


class _LnBias(nn.Module):
  def __init__(self, c):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(c))
    self.bias = nn.Parameter(torch.zeros(c))


class ExtraConvs(nn.Module):
  """x = LN(x); x = x + conv_out(gelu(conv_up(x))), five layers."""

  def __init__(self, c=256, layers=5):
    super().__init__()
    self.layers = layers
    for i in range(layers):
      self.add_module(f"ln_{i}", _LnBias(c))
      self.add_module(f"conv_up_{i}", Conv(c, 4 * c, 3))
      self.add_module(f"conv_out_{i}", Conv(4 * c, c, 3))

  def forward(self, x):
    for i in range(self.layers):
      ln = getattr(self, f"ln_{i}")
      xf = x.float()
      mu = xf.mean(1, keepdim=True)
      var = (xf * xf).mean(1, keepdim=True) - mu * mu
      xf = (xf - mu) * torch.rsqrt(var + _EPS) * ln.scale[:, None, None]
      x = (xf + ln.bias[:, None, None]).to(x.dtype)
      x = x + getattr(self, f"conv_out_{i}")(
          gelu(getattr(self, f"conv_up_{i}")(x)))
    return x


def _linear(x, layer, dtype=None):
  dtype = dtype or x.dtype
  return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class CostVolumeHead(nn.Module):
  def __init__(self, temperature):
    super().__init__()
    self.temperature = temperature
    self.pos_conv = Conv(1, 16, 3)
    self.pos_out = Conv(16, 1, 3)
    self.occ_conv = Conv(16, 32, 3)
    self.occ_dense = nn.Linear(32, 16)
    self.occ_out = nn.Linear(16, 2)

  def forward(self, qf, grid, query_points, im_shape):
    b, t, h, w, _ = grid.shape
    n = qf.shape[1]
    cost = torch.einsum("bnc,bthwc->tbnhw", qf.float(), grid.float())
    hid = torch.relu(self.pos_conv(cost.reshape(t * b * n, 1, h, w)))
    pos = self.pos_out(hid).reshape(t, b, n, h, w).permute(1, 2, 0, 3, 4)
    pos = torch.softmax((pos * self.temperature).reshape(b, n, t, h * w),
                        dim=-1).reshape(b, n, t, h, w)
    points = heatmaps_to_points(pos, im_shape, query_points)
    occ = torch.relu(self.occ_conv(hid, stride=2)).mean(dim=(2, 3))
    occ = _linear(torch.relu(_linear(occ, self.occ_dense)), self.occ_out)
    occ = occ.reshape(t, b, n, 2)
    return points, occ[..., 0].permute(1, 2, 0), occ[..., 1].permute(1, 2, 0)


class _Scale(nn.Module):
  def __init__(self, c):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(c))


class _Depthwise(nn.Module):
  def __init__(self, features, k):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(k, 1, features))
    self.bias = nn.Parameter(torch.zeros(features))


class _Temporal(nn.Module):
  def __init__(self, c, k):
    super().__init__()
    self.dw_up = _Depthwise(4 * c, k)
    self.dw_mix = _Depthwise(4 * c, k)


def layer_norm(x, scale, eps=_EPS):
  xf = x.float()
  mean = xf.mean(-1, keepdim=True)
  var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
  return ((xf - mean) * (torch.rsqrt(var + eps) * scale.float())).to(x.dtype)


def temporal_depthwise(x, w_up, b_up, w_mix, b_mix):
  """SAME depthwise conv (x4 lanes) -> GELU -> depthwise conv -> lanes
  summed, in float32."""
  k = w_up.shape[0]
  b, t, c = x.shape
  mult = w_up.shape[-1] // c
  wu = w_up.float().reshape(k, c, mult)
  wm = w_mix.float().reshape(k, c, mult)
  bu = b_up.float().reshape(c, mult)
  bm = b_mix.float().reshape(c, mult)
  left = (k - 1) // 2
  xp = F.pad(x.float(), (0, 0, left, k - 1 - left))
  y = torch.zeros_like(x, dtype=torch.float32) + bm.sum(-1)
  for m in range(mult):
    h = torch.zeros_like(y) + bu[:, m]
    for j in range(k):
      h = h + xp[:, j:j + t] * wu[j, :, m]
    hp = F.pad(gelu(h), (0, 0, left, k - 1 - left))
    for j in range(k):
      y = y + hp[:, j:j + t] * wm[j, :, m]
  return y.to(x.dtype)


class MixerBlock(nn.Module):
  def __init__(self, c, k):
    super().__init__()
    self.ln_temporal = _Scale(c)
    self.temporal = _Temporal(c, k)
    self.ln_channel = _Scale(c)
    self.fc_up = nn.Linear(c, 4 * c)
    self.fc_down = nn.Linear(4 * c, c)

  def forward(self, x):
    t = self.temporal
    x = x + temporal_depthwise(layer_norm(x, self.ln_temporal.scale),
                               t.dw_up.weight, t.dw_up.bias, t.dw_mix.weight,
                               t.dw_mix.bias)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + _EPS) * self.ln_channel.scale).to(x.dtype)
    dt = x.dtype
    h = gelu(torch.matmul(xn, self.fc_up.weight.t().to(dt)).float()
             + self.fc_up.bias).to(dt)
    y = torch.matmul(h, self.fc_down.weight.t().to(dt)).float() + self.fc_down.bias
    return x + y.to(dt)


class PipsMixer(nn.Module):
  def __init__(self, cin, cout, hidden, blocks, k):
    super().__init__()
    self.blocks = blocks
    self.in_proj = nn.Linear(cin, hidden)
    for i in range(blocks):
      self.add_module(f"block_{i}", MixerBlock(hidden, k))
    self.ln_out = _Scale(hidden)
    self.out_proj = nn.Linear(hidden, cout)

  def forward(self, x):
    x = _linear(x, self.in_proj)
    for i in range(self.blocks):
      x = getattr(self, f"block_{i}")(x)
    return _linear(layer_norm(x, self.ln_out.scale), self.out_proj, torch.float32)


def tent_weights(coords, size, p):
  offsets = torch.arange(p, dtype=coords.dtype, device=coords.device) - (p - 1) / 2
  cells = torch.arange(size, dtype=coords.dtype, device=coords.device)
  return torch.relu(1.0 - ((coords[..., None] + offsets)[..., None] - cells).abs())


def corr_patches(grid, query, cy, cx, p, dtype):
  """[BT, H, W, C] x [BT, N, C] at centres [BT, N] (index space) ->
  [BT, p, p, N]: the correlation rounded to `dtype`, tents in float32."""
  corrs = torch.einsum("bhwc,bnc->bnhw", grid.float(), query.float()).to(dtype)
  h, w = grid.shape[1:3]
  wy = tent_weights(cy.float(), h, p).to(dtype)
  wx = tent_weights(cx.float(), w, p).to(dtype)
  pat = torch.einsum("bnph,bnhw->bnpw", wy.float(), corrs.float()).to(dtype)
  pat = torch.einsum("bnqw,bnpw->bnpq", wx.float(), pat.float())
  return pat.permute(0, 2, 3, 1)


# ------------------------------------------------------------ the model


class TAPIR(nn.Module):
  """Offline TAPIR with the configuration's fields (a `configs/*.json`
  "model" object)."""

  def __init__(self, cfg: Mapping):
    super().__init__()
    self.cfg = dict(cfg)
    self.backbone = ResNet(cfg["blocks_per_group"],
                           (64, cfg["highres_dim"], 256, cfg["lowres_dim"]))
    self.extra = ExtraConvs(cfg["lowres_dim"]) if cfg["extra_convs"] else None
    self.cost_volume_head = CostVolumeHead(cfg["softmax_temperature"])
    feats = cfg["highres_dim"] + cfg["lowres_dim"]
    p2 = cfg["patch_size"] ** 2
    self.mixer = PipsMixer(4 + feats + p2 * (2 + cfg["pyramid_level"]),
                           4 + feats, cfg["mixer_hidden_dim"],
                           cfg["num_mixer_blocks"], cfg["mixer_kernel_size"])
    self.dtype = torch.float32

  def _features(self, video, frame_chunk):
    """(lowres, hires) l2-normalised grids [B, T, h, w, C] of video
    [B, T, H, W, 3], `frame_chunk` frames at a time."""
    b, t = video.shape[:2]
    lows, his = [], []
    for i in range(0, t, frame_chunk):
      part = video[:, i:i + frame_chunk]
      x = part.reshape((-1,) + tuple(part.shape[2:])).permute(0, 3, 1, 2)
      lo, hi = self.backbone(x.to(self.dtype))
      if self.extra is not None:
        lo = self.extra(lo)
      lows.append(lo.permute(0, 2, 3, 1))
      his.append(hi.permute(0, 2, 3, 1))
    norm = lambda x: (x.float() * torch.rsqrt(torch.clamp(
        x.float().square().sum(-1, keepdim=True), min=1e-12))).to(x.dtype)
    cat = lambda xs: norm(torch.cat(xs).reshape((b, t) + tuple(xs[0].shape[1:])))
    return cat(lows), cat(his)

  def forward(self, video, query_points, refinement_resolutions,
              query_chunk, frame_chunk):
    """tracks [B, N, T, 2] (x, y), occlusion and expected_dist [B, N, T]."""
    cfg = self.cfg
    init = tuple(cfg["initial_resolution"])
    resolutions = [init] + [tuple(r) for r in (
        refinement_resolutions or default_resolutions(
            tuple(video.shape[2:4]), init))]
    grids = {}
    video = video.float()
    for r in resolutions:
      if r not in grids:
        grids[r] = self._features(resize_video(video, r), frame_chunk)
    vshape = tuple(video.shape)
    n = query_points.shape[1]
    outs = [self._track(grids, resolutions, vshape, query_points[:, i:i + query_chunk])
            for i in range(0, n, query_chunk)]
    return {k: torch.cat([o[k] for o in outs], 1)
            for k in ("tracks", "occlusion", "expected_dist")}

  def _query_feats(self, grid, vshape, qp):
    return sample_grid(grid, convert_coords(
        qp, vshape[1:4], tuple(grid.shape[1:4])))

  def _track(self, grids, resolutions, vshape, qp):
    cfg = self.cfg
    init = tuple(cfg["initial_resolution"])
    t = vshape[1]
    lo0, _ = grids[resolutions[0]]
    im_shape = (vshape[0], t) + init + (3,)
    qp_init = convert_coords(qp, (t,) + vshape[2:4], (t,) + init)
    points, occ, expd = self.cost_volume_head(
        self._query_feats(lo0, vshape, qp), lo0, qp_init, im_shape)
    to_video = lambda x: convert_coords(x, init[::-1], vshape[2:4][::-1])
    init_occ, init_expd = occ, expd
    p = cfg["patch_size"]
    keep = []
    iters = cfg["num_pips_iter"]
    for level in range(1, len(resolutions)):
      lo, hi = grids[resolutions[level]]
      q_lo = self._query_feats(lo, vshape, qp)
      q_hi = self._query_feats(hi, vshape, qp)
      pyramid = [hi, lo]
      for _ in range(cfg["pyramid_level"]):
        g = pyramid[-1]
        bb, tt, h, w, c = g.shape
        g = g[:, :, :h // 2 * 2, :w // 2 * 2].reshape(bb, tt, h // 2, 2, w // 2, 2, c)
        pyramid.append(g.float().mean(dim=(3, 5)).to(g.dtype))
      feats = None
      occ, expd = init_occ, init_expd
      for _ in range(iters):
        qs = [q_hi, q_lo] + [q_lo] * cfg["pyramid_level"]
        if feats is not None:
          qs = [feats[..., :cfg["highres_dim"]]] + [feats[..., cfg["highres_dim"]:]] * (
              1 + cfg["pyramid_level"])
        corrs = torch.cat([self._corr(g, q, points, p) for g, q in zip(pyramid, qs)], -1)
        b, n, tt, _ = corrs.shape
        base = (torch.cat([q_hi, q_lo], -1)[:, :, None].expand(-1, -1, tt, -1)
                if feats is None else feats)
        x = torch.cat([torch.zeros_like(points), occ[..., None], expd[..., None],
                       base.float(), corrs], -1)
        res = self.mixer(x.reshape(b * n, tt, -1).to(self.dtype)).reshape(b, n, tt, -1)
        rh, rw = resolutions[level]
        points = convert_coords(res[..., :2], (rw, rh), init[::-1]) + points
        occ = res[..., 2] + occ
        expd = res[..., 3] + expd
        feats = res[..., 4:] + base
      keep.append((to_video(points), occ, expd))
    return {"tracks": torch.stack([k[0] for k in keep]).mean(0),
            "occlusion": torch.stack([k[1] for k in keep]).mean(0),
            "expected_dist": torch.stack([k[2] for k in keep]).mean(0)}

  def _corr(self, grid, query, points, p):
    """[B, N, T, p*p] local correlation around `points` [B, N, T, 2] (x, y
    at the initial resolution)."""
    b, t, h, w, c = grid.shape
    n = query.shape[1]
    init = tuple(self.cfg["initial_resolution"])
    coords = convert_coords(points, init[::-1], (w, h)).flip(-1) - 0.5
    q = (query.permute(0, 2, 1, 3) if query.ndim == 4
         else query[:, None].expand(b, t, n, c)).reshape(b * t, n, c)
    cy = coords[..., 0].permute(0, 2, 1).reshape(b * t, n)
    cx = coords[..., 1].permute(0, 2, 1).reshape(b * t, n)
    pat = corr_patches(grid.reshape(b * t, h, w, c), q.to(self.dtype), cy, cx,
                       p, self.dtype)
    return pat.reshape(b, t, p, p, n).permute(0, 4, 1, 2, 3).reshape(b, n, t, p * p)


def build(cfg: Mapping, params: Mapping, device) -> TAPIR:
  """The reference model on `device` with the tree's weights (strict)."""
  model = TAPIR(cfg)
  model.load_state_dict(state_dict(params), strict=True)
  return model.to(device).eval()


@torch.no_grad()
def track(model: TAPIR, video, query_points, refinement_resolutions,
          query_chunk: int, frame_chunk: int):
  """tracks [B, N, T, 2] (x, y), occlusion and expected_dist [B, N, T] of
  one request."""
  return model(video, query_points, refinement_resolutions, query_chunk,
               frame_chunk)
