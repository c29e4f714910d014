"""The yardstick's arithmetic: the card's peaks, each kernel's least time
from its call's shapes, and the model FLOPs of one request.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM (dense, no
sparsity): 3.35 TB/s of HBM3, 989 TFLOP/s in bf16 on the tensor cores, 495
in TF32. A float32-accurate product on the tensor cores is three TF32
products (error-compensated TF32, as the mixer kernel's float32 form
computes it), so float32 products are bound at a third of the TF32 peak.

A kernel's bound is the larger of its bytes over the bandwidth and its
operations over the peak of its operands: each input byte read once, each
output byte written once (the corr-tents kernel: only the grid positions its
windows touch), whatever the kernel reads again.

The model FLOPs count 2 * multiply-adds from the configuration's shapes,
whatever kernel computes them, so a change of kernel or precision moves
`mfu` only through time.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_TF32_FLOPS / 3}
# `mfu`'s one peak for every cell and dtype, so that a change of precision
# shows.
MFU_PEAK_FLOPS = PEAK_BF16_FLOPS

ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
  """Least seconds of a call: bytes over bandwidth or operations over the
  operands' peak, whichever is larger."""
  return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ------------------------------------------------------------------ kernels


def corr_touched(cy: torch.Tensor, cx: torch.Tensor, h: int, w: int,
                 p: int = 7) -> Tuple[int, int]:
  """(grid positions touched, in-grid window positions) of one corr-tents
  call with window centres cy, cx [BT, N] in grid index space: each centre
  reads the (p+1) x (p+1) positions from floor(c) - (p-1)/2 on."""
  bt = cy.shape[0]
  win = torch.arange(p + 1, device=cy.device)
  ys = torch.floor(cy).long()[..., None] - (p - 1) // 2 + win  # [BT, N, p+1]
  xs = torch.floor(cx).long()[..., None] - (p - 1) // 2 + win
  yy = ys[..., :, None].expand(-1, -1, -1, p + 1)
  xx = xs[..., None, :].expand(-1, -1, p + 1, -1)
  ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
  bb = torch.arange(bt, device=cy.device)[:, None, None, None].expand_as(yy)
  touched = torch.zeros(bt, h, w, dtype=torch.bool, device=cy.device)
  touched[bb[ok], yy[ok], xx[ok]] = True
  return int(touched.sum()), int(ok.sum())


def corr_bound_s(touched: int, in_grid: int, bt: int, n: int, c: int,
                 dtype: str, p: int = 7) -> float:
  """Bound of one corr-tents call on a [BT, H, W, C] grid with N queries a
  frame: the touched grid positions, the [BT, N, C] queries, the centres
  (float32) and the [BT, p, p, N] float32 output; 2 * C operations a window
  position of each query."""
  elt = ELEMENT_BYTES[dtype]
  nbytes = (touched * c * elt + bt * n * c * elt + 2 * bt * n * 4
            + bt * p * p * n * 4)
  return bound_s(nbytes, 2.0 * in_grid * c, dtype)


def mixer_bound_s(rows_b: int, t: int, c: int, hidden: int, dtype: str,
                  kernel_size: int = 3, multiplier: int = 4) -> float:
  """Bound of one mixer-block call on x [B, T, C]: x read and written, the
  block's parameters read once; the channel MLP's two products."""
  elt = ELEMENT_BYTES[dtype]
  params = (2 * c + 2 * kernel_size * multiplier * c + 2 * multiplier * c
            + c * hidden + hidden + hidden * c + c)
  nbytes = 2 * rows_b * t * c * elt + params * elt
  flops = 2.0 * rows_b * t * c * hidden * 2
  return bound_s(nbytes, flops, dtype)


def scan_bound_s(b: int, t: int, c: int, dtype: str = "float32") -> float:
  """Bound of one linear scan over x, a [B, T, C]: x and a read and y
  written in their dtype, h0 read and h_last written in float32; a multiply
  and an add per element (float32)."""
  elt = ELEMENT_BYTES[dtype]
  nbytes = 3 * b * t * c * elt + 2 * b * c * 4
  return bound_s(nbytes, 2.0 * b * t * c, "float32")


# -------------------------------------------------------------- model FLOPs


def _conv_macs(h: int, w: int, cin: int, cout: int, k: int,
               stride: int) -> Tuple[float, int, int]:
  """(multiply-adds, out h, out w) of a SAME convolution."""
  ho, wo = -(-h // stride), -(-w // stride)
  return float(ho * wo * k * k * cin * cout), ho, wo


def resnet_macs(res: Tuple[int, int], blocks: Sequence[int],
                channels: Sequence[int], strides: Sequence[int] = (1, 2, 2, 1),
                stem_channels: int = 64) -> float:
  """Multiply-adds of TAPIR's ResNet v2 (7x7 / 2 stem, 3x3 blocks, a 1x1
  projection on each group's first block) on one frame."""
  macs, h, w = _conv_macs(res[0], res[1], 3, stem_channels, 7, 2)
  cin = stem_channels
  for n, cout, stride in zip(blocks, channels, strides):
    for b in range(n):
      s = stride if b == 0 else 1
      m0, ho, wo = _conv_macs(h, w, cin, cout, 3, s)
      m1, _, _ = _conv_macs(ho, wo, cout, cout, 3, 1)
      macs += m0 + m1
      if b == 0:
        macs += float(ho * wo * cin * cout)
      h, w, cin = ho, wo, cout
  return macs


def tapir_flops(cfg: Dict, frames: int, res: Tuple[int, int],
                refinement_res: Sequence[Tuple[int, int]],
                queries: int) -> float:
  """Model FLOPs of one TAPIR request: the backbone (ResNet and
  ExtraConvs) once at each distinct resolution, stage 1's cost volume and
  heads, and per refinement iteration the local correlation (2 * C a window
  position of each query at each pyramid level) and the PIPs mixer."""
  del res  # the backbone runs at the initial and refinement resolutions
  init = tuple(cfg["initial_resolution"])
  resolutions = {init, *[tuple(r) for r in refinement_res]}
  lo_c, hi_c = cfg["lowres_dim"], cfg["highres_dim"]
  channels = (64, hi_c, 256, lo_c)
  macs = 0.0
  for r in resolutions:
    per_frame = resnet_macs(r, cfg["blocks_per_group"], channels)
    if cfg["extra_convs"]:
      gh, gw = -(-r[0] // 8), -(-r[1] // 8)
      per_frame += 5 * 2 * 9 * lo_c * 4 * lo_c * gh * gw
    macs += per_frame * frames
  # Stage 1 at the initial resolution's stride-8 grid.
  gh, gw = init[0] // 8, init[1] // 8
  maps = frames * queries
  macs += maps * gh * gw * lo_c  # cost volume
  macs += maps * gh * gw * 9 * 1 * 16  # pos_conv
  macs += maps * gh * gw * 9 * 16 * 1  # pos_out
  macs += maps * (gh // 2) * (gw // 2) * 9 * 16 * 32  # occ_conv, stride 2
  macs += maps * (32 * 16 + 16 * 2)
  # Refinement.
  p = cfg["patch_size"]
  levels = [hi_c, lo_c] + [lo_c] * cfg["pyramid_level"]
  corr = sum(c * (p + 1) ** 2 for c in levels)
  hid = cfg["mixer_hidden_dim"]
  k = cfg["mixer_kernel_size"]
  c_in = 4 + hi_c + lo_c + p * p * (2 + cfg["pyramid_level"])
  c_out = 4 + hi_c + lo_c
  mixer = (c_in * hid + cfg["num_mixer_blocks"] * (2 * hid * 4 * hid
                                                   + 2 * k * 4 * hid)
           + hid * c_out)
  iters = cfg["num_pips_iter"] * len(refinement_res)
  macs += iters * maps * (corr + mixer)
  return 2.0 * macs


def tapnext_flops(cfg: Dict, frames: int, queries: int) -> float:
  """Model FLOPs of one TAPNext pass: per token and layer the SSM block's
  products (linear_x, linear_y, linear_out, ffw_up, ffw_down, the
  block-diagonal gates), the ViT block's (q, k, v, out, MLP) and
  attention's two products over the frame's tokens."""
  d, m, heads = cfg["width"], cfg["mlp_dim"], cfg["num_heads"]
  _, ph, pw = cfg["patch_size"]
  tokens = (cfg["image_size"][0] // ph) * (cfg["image_size"][1] // pw) + queries
  per_token = (3 * d * d + 2 * d * m + d * m + 2 * d * (d // heads)
               + 4 * d * d + 2 * d * m + 2 * tokens * d)
  return 2.0 * frames * tokens * cfg["depth"] * per_token
