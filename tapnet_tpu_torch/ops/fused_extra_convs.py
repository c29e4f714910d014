"""One ExtraConvs layer with per-pixel int8 scales (port of
tapnet_tpu/ops/fused_extra_convs.py).

An ExtraConvs layer is

    t = LayerNorm(x) * g + b;  y = t + conv3x3_out(gelu(conv3x3_up(t)))

with a 4x channel expansion in the middle. `extra_convs_layer` keeps the JAX
public layout: x [N, H, W, C] (N = batch * frames); g, bln [C]; wu
[3, 3, C, M] and wo [3, 3, M, C] (HWIO); bu [M]; bo [C].

`quantized=True` is the per-pixel w8a8 scheme of the JAX kernel, which only a
tap-decomposed kernel can dequantize exactly:
  * conv_up quantizes each output pixel's whole 3x3xC receptive field (its
    patch) with one scale, the patch's amax: the same input value is
    quantized differently for each of the 9 output pixels that read it;
  * conv_out quantizes the hidden per pixel and dequantizes each tap's
    integer partial with the scale of the pixel that tap reads, so the scale
    cannot leave the tap sum;
  * weights are quantized per output channel; LN, GELU and the residual stay
    float32 from the LayerNorm to the final cast to x.dtype.

  * CPU tensors run `extra_convs_layer_reference`, the port of the JAX
    `_math_reference` (both `quantized` branches), the int8 products as
    float64 matrix products of the int8 values (exact).
  * CUDA tensors with `quantized=True` launch K6,
    `extra_convs_q8_pixel_forward` of `csrc/extra_convs.cu`.
  * CUDA tensors with `quantized=False` raise: no path of the model runs the
    float fused layer (`wants_fused` demands the per-pixel mode), so it has
    no kernel. Any other device raises too.

`wants_fused` is the JAX package's gate, and it chooses the *math*: the
per-pixel scheme runs only where it holds; below it the ExtraConvs take the
per-frame scheme (`ops.qconv.conv2d_q8`), exactly as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.ops import _build, qconv
from tapnet_tpu_torch.ops.mixer_math import gelu

# Number of CUDA launches of K6 made through `extra_convs_layer` (one per
# layer call: its six kernels count once).
LAUNCHES = 0

# The JAX gate's size threshold: the per-pixel scheme runs on activations of
# at least this many elements.
_MIN_FUSED_ELEMENTS = 4 * 1024 * 1024

_EPS = 1e-5


def wants_fused(x: torch.Tensor, per_pixel: bool = False) -> bool:
  """The JAX gate: the per-pixel mode, 4-D [N, H, W, C] activations of at
  least _MIN_FUSED_ELEMENTS elements, C a multiple of 128."""
  return (
      per_pixel
      and x.ndim == 4
      and x.numel() >= _MIN_FUSED_ELEMENTS
      and x.shape[-1] % 128 == 0
  )


def _ln_bias(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """LayerNorm over the last axis with scale and bias, float32 single-pass
  statistics, float32 output."""
  xf = x.float()
  mu = xf.mean(-1, keepdim=True)
  var = (xf * xf).mean(-1, keepdim=True) - mu * mu
  return (xf - mu) * torch.rsqrt(var + _EPS) * g.float() + b.float()


def _q_rows(v: torch.Tensor):
  """Symmetric per-row int8 quantization of float32 [..., C]: (int8, scale
  [..., 1])."""
  return qconv.quantize_symmetric(v, v.abs().amax(-1, keepdim=True))


def quantized_weights(wu: torch.Tensor, wo: torch.Tensor):
  """(wuq int8 [M, 3, 3, C], su [M], woq int8 [C, 3, 3, M], so [C]) of the
  HWIO kernels, in the layout the kernels read."""
  return (*qconv.quantize_conv_weight(wu.permute(3, 2, 0, 1)),
          *qconv.quantize_conv_weight(wo.permute(3, 2, 0, 1)))


def _conv_fp(v, w, b):
  """SAME 3x3 conv of [N, H, W, C_in] with an HWIO kernel: operands in
  v.dtype, float32 accumulation and output (products of bf16 values are exact
  in float32), + bias."""
  w = w.to(v.dtype).float().permute(3, 2, 0, 1)
  y = F.conv2d(v.float().permute(0, 3, 1, 2), w, padding=1)
  return y.permute(0, 2, 3, 1) + b.float()


def _conv_q8_patch(v32, wuq, su, b):
  """conv_up: one scale per output pixel over its 3x3xC patch, one integer
  product over the concatenated patch."""
  patches = torch.cat([qconv.shifted(v32, dy, dx) for dy, dx in qconv.TAPS], -1)
  pq, ps = _q_rows(patches)
  acc = torch.matmul(pq.double(), wuq.reshape(wuq.shape[0], -1).double().t())
  return acc.float() * (ps * su) + b.float()


def _conv_q8(v32, woq, so, b):
  """conv_out: per-pixel scales, each tap's integer partial dequantized with
  the scale of the pixel it reads, summed from zero in tap order. Returns
  (output, int8 operand, its pixel scales)."""
  vq, vs = _q_rows(v32)
  acc = torch.zeros(v32.shape[:-1] + (woq.shape[0],), dtype=torch.float32,
                    device=v32.device)
  for (dy, dx), part in zip(qconv.TAPS, qconv.int8_tap_products(vq, woq)):
    acc = acc + part.float() * (qconv.shifted(vs, dy, dx) * so)
  return acc + b.float(), vq, vs


def _layer_reference(x, g, bln, wu, bu, wo, bo, quantized, qweights,
                     parts=False):
  """The layer; with `parts` (quantized only), also (t32, the int8 hidden
  and its pixel scales)."""
  t32 = _ln_bias(x, g, bln)
  if quantized:
    wuq, su, woq, so = qweights
    hidden = gelu(_conv_q8_patch(t32, wuq, su, bu))
    out, hq, hs = _conv_q8(hidden, woq, so, bo)
  else:
    hidden = gelu(_conv_fp(t32.to(x.dtype), wu, bu)).to(x.dtype)
    out = _conv_fp(hidden, wo, bo)
  y = (t32 + out).to(x.dtype)
  return (y, t32, hq, hs) if parts else y


def extra_convs_layer_reference(x, g, bln, wu, bu, wo, bo,
                                quantized: bool = False, qweights=None):
  """Plain version of the layer (the JAX `_math_reference`), over frame
  chunks. With `quantized`, `qweights` may give `quantized_weights(wu, wo)`
  made once; wu and wo are then not read."""
  if quantized and qweights is None:
    qweights = quantized_weights(wu, wo)
  width = 9 * x.shape[-1] + 4 * bu.shape[0]
  return qconv.over_frames(
      lambda v: _layer_reference(v, g, bln, wu, bu, wo, bo, quantized,
                                 qweights),
      x, width)


# Share of any one pixel's int8 hidden values that `q8_error_limit` lets the
# kernel and the plain version hold one step apart; the card's checks hold
# the kernel's own int8 hidden to it, pixel by pixel. Flips cluster: float32
# noise in t32 moves a patch value across a rounding boundary, and since
# neighbouring output pixels share their patch scale (the max of the same
# pixel amaxes), up to 9 patches flip it alike. Each such pixel's whole
# hidden row then moves by up to cs * |wuq| * su, a tenth of a hidden step at
# the served widths, and a few per cent of its values flip, while the share
# over all values stays near 2e-5 (H100 at the served shapes, PERF.md §6).
Q8_PIXEL_FLIP_SHARE = 1 / 16


def q8_error_limit(x, g, bln, bu, bo, qweights):
  """Per-element limit [N, H, W, C] float32 on |kernel - plain| for the
  per-pixel layer, and the plain version's int8 hidden [N*H*W, M] to count
  flips against.

  Integer arithmetic is exact on both sides and the quantizers make the same
  roundings, so the two differ where float32 noise (LayerNorm sums, rsqrt,
  tanh) moves a patch or hidden value across an int8 rounding boundary. A
  hidden value one step apart at pixel q moves out[p, col] at each pixel p
  that reads q, through tap j, by hs[q] * |woq[col, j, k]| * so[col]; if a
  share Q8_PIXEL_FLIP_SHARE of each pixel's hidden values flip with
  independent signs, out[p, col] moves by about sqrt(share) * so[col] *
  sqrt(sum_j hs[p + off_j]^2 * ||woq[col, j]||^2). The limit is four such
  deviations (a step of a patch value moves the float hidden, which reaches
  the output only through such flips), plus the output's own rounding: in
  float32 1e-5 absolute and relative (t32 and the tap sums), in bfloat16 two
  bf16 steps of |y| where the two sides round y separately.
  """
  wuq, su, woq, so = qweights
  n, h, w, c = x.shape
  y, _, hq, hs = qconv.over_frames(
      lambda v: _layer_reference(v, g, bln, None, bu, None, bo, True,
                                 qweights, parts=True),
      x, 9 * c + 4 * wuq.shape[0])
  y = y.float()
  tap_norm2 = woq.float().square().sum(-1)  # [C, 3, 3]
  spread = torch.zeros_like(y)
  for dy, dx in qconv.TAPS:
    spread += qconv.shifted(hs, dy, dx).square() * tap_norm2[:, dy + 1, dx + 1]
  limit = 4 * Q8_PIXEL_FLIP_SHARE**0.5 * so * spread.sqrt()
  if x.dtype == torch.bfloat16:
    limit = limit + 2 * 2.0**-7 * y.abs()
  else:
    limit = limit + 1e-5 * (1 + y.abs())
  return limit, hq.reshape(n * h * w, -1)


def q8_output_controls(x, g, bln, bu, bo, qweights):
  """Faulty versions of the plain per-pixel layer on x, which
  `q8_error_limit` must refuse in float32: `bf16_t32_residual` adds t32
  rounded to bfloat16 (a kernel that keeps its LayerNorm output in bf16:
  up to 2^-9 |t32|); `output_pixel_scale` dequantizes each conv_out tap with
  the output pixel's scale, not with that of the pixel the tap reads."""
  wuq, su, woq, so = qweights
  t32 = _ln_bias(x, g, bln)
  out, hq, hs = _conv_q8(gelu(_conv_q8_patch(t32, wuq, su, bu)), woq, so, bo)
  own_scale = sum(part.float() * (hs * so)
                  for part in qconv.int8_tap_products(hq, woq)) + bo.float()
  return {"bf16_t32_residual": (t32.bfloat16().float() + out).to(x.dtype),
          "output_pixel_scale": (t32 + own_scale).to(x.dtype)}


def _launch(x, g, bln, bu, bo, qweights, scratch=None):
  """K6 on the card. If `scratch` is a dict, the kernels' intermediates are
  left in it (t32, the patch scales, the float32 hidden, the int8 hidden and
  its pixel scales), for checks."""
  global LAUNCHES
  if x.dtype not in qconv.DTYPES:
    raise TypeError(
        f"extra_convs_layer: x must be float32 or bfloat16, got {x.dtype}")
  if x.ndim != 4 or not x.is_contiguous():
    raise ValueError("extra_convs_layer: x must be a contiguous [N, H, W, C]")
  n, h, w, c = x.shape
  wuq, su, woq, so = qweights
  m = wuq.shape[0]
  dev = x.device
  qconv._check_int8_conv_weights("extra_convs_layer", wuq, su, c, dev)  # pylint: disable=protected-access
  qconv._check_int8_conv_weights("extra_convs_layer", woq, so, m, dev)  # pylint: disable=protected-access
  if woq.shape[0] != c:
    raise ValueError(f"extra_convs_layer: conv_out has {woq.shape[0]} outputs, x {c}")
  if c % 16 or m % 64:
    raise ValueError(
        "extra_convs_layer: K6 needs C a multiple of 16 and the hidden width "
        f"a multiple of 64, got {c} and {m}")
  for name, p, size in (("g", g, c), ("bln", bln, c), ("bu", bu, m), ("bo", bo, c)):
    if tuple(p.shape) != (size,) or p.device != dev:
      raise ValueError(f"extra_convs_layer: {name} must be [{size}] on {dev}")
  g32, bln32, bu32, bo32 = (p.float().contiguous() for p in (g, bln, bu, bo))

  lib = _build.load("extra_convs", qconv.SIGNATURES)
  rows = n * h * w
  f32 = dict(dtype=torch.float32, device=dev)
  t32 = torch.empty((rows, c), **f32)
  pixel_amax = torch.empty((rows,), **f32)
  patch_scale = torch.empty((rows,), **f32)
  hidden = torch.empty((rows, m), **f32)
  hidden_amax = torch.empty((rows,), dtype=torch.int32, device=dev)
  hq = torch.empty((rows, m), dtype=torch.int8, device=dev)
  hs = torch.empty((rows,), **f32)
  out = torch.empty_like(x)
  operands = (x, g32, bln32, wuq, su, bu32, woq, so, bo32, t32, pixel_amax,
              patch_scale, hidden, hidden_amax, hq, hs, out)
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = lib.extra_convs_q8_pixel_forward(
        *[o.data_ptr() for o in operands], n, h, w, c, m,
        qconv.DTYPES[x.dtype], stream,
    )
  _build.check(lib, err, "extra_convs_q8_pixel_forward")
  LAUNCHES += 1
  if scratch is not None:
    scratch.update(t32=t32, patch_scale=patch_scale, hidden=hidden, hq=hq,
                   hs=hs)
  return out


def extra_convs_layer(x, g, bln, wu, bu, wo, bo, quantized: bool = False,
                      qweights=None):
  """One ExtraConvs layer: LN with bias -> conv3x3 (C -> M) -> GELU ->
  conv3x3 (M -> C) -> residual on the LN output.

  Args:
    x: [N, H, W, C] activations.
    g / bln: [C] LayerNorm scale and bias.
    wu: [3, 3, C, M]; bu: [M]; wo: [3, 3, M, C]; bo: [C].
    quantized: the per-pixel w8a8 scheme (see module docstring).
    qweights: with `quantized`, `quantized_weights(wu, wo)` made once by the
      caller; wu and wo are then not read and may be None.

  Returns:
    [N, H, W, C] in x.dtype.
  """
  if x.device.type == "cpu":
    return extra_convs_layer_reference(x, g, bln, wu, bu, wo, bo, quantized,
                                       qweights)
  if x.device.type == "cuda":
    if not quantized:
      raise ValueError(
          "extra_convs_layer: the float fused layer has no CUDA kernel; no "
          "model path reaches it (wants_fused demands the per-pixel mode).")
    if qweights is None:
      qweights = quantized_weights(wu, wo)
    return _launch(x.contiguous(), g, bln, bu, bo, qweights)
  raise ValueError(f"extra_convs_layer: unsupported device {x.device}")
