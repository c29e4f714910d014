"""One ExtraConvs layer, in full precision or with per-pixel int8 scales
(port of tapnet_tpu/ops/fused_extra_convs.py).

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
  * CUDA tensors with `quantized=False` launch K6f, `extra_convs_fp_forward`
    of the same source (the JAX `_math_reference(quantized=False)`: conv
    operands in x.dtype, float32 sums, the hidden rounded to x.dtype, the
    residual on the float32 LN output). Its two products are one GEMM each
    over zero-ringed frames on the TMA + wgmma loop of `csrc/tma_gemm.cuh`,
    as X's (`fp_launch_plan`): bf16 in bf16, float32 as error-compensated
    TF32 (`fp_padded_slab` emulates the indexing, and with `terms` the
    float32 arithmetic). No model path reaches it, as in JAX: `wants_fused`
    demands the per-pixel mode, and `layers.ExtraConvs` runs its float
    layers as plain convolutions.
  * Any other device raises. There is no size gate and no fallback.

`wants_fused` is the JAX package's gate, and it chooses the *math*: the
per-pixel scheme runs only where it holds; below it the ExtraConvs take the
per-frame scheme (`ops.qconv.conv2d_q8`), exactly as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.ops import _build, _vjp, qconv, tma_gemm
from tapnet_tpu_torch.ops.mixer_math import gelu

# Number of CUDA launches made through `extra_convs_layer`, one per layer
# call: K6 (its four kernels count once) and K6f (three kernels; five in
# float32, with the weights' split).
LAUNCHES = 0
LAUNCHES_FP = 0

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


def _conv_fp(v, w, b, padding=1, terms=None):
  """3x3 conv of [N, H, W, C_in] with an HWIO kernel (SAME with padding 1,
  VALID with 0): operands in v.dtype, float32 products (exact for bf16
  values) summed in float32, + bias. Written as 9 tap matmuls, so that the
  sums are of the products themselves on any device, whatever algorithm a
  convolution library would pick (Winograd and FFT algorithms transform the
  operands first). With `terms` (float32 operands), the products of the
  operands' TF32 parts that `tma_gemm.TF32X3_TERMS[terms]` names, summed in
  float64 and rounded to float32 once."""
  w = w.to(v.dtype).float()
  vp = F.pad(v.float(), (0, 0, padding, padding, padding, padding))
  h, wd = vp.shape[1] - 2, vp.shape[2] - 2
  pairs = [(vp, w)] if terms is None else tma_gemm.tf32x3_pairs(vp, w, terms)
  acc = 0
  for a, k in pairs:
    for dy in range(3):
      for dx in range(3):
        acc = acc + torch.matmul(a[:, dy : dy + h, dx : dx + wd], k[dy, dx])
  return acc.float() + b.float()


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
                     parts=False, terms=None):
  """The layer; with `parts` (quantized only), also (t32, the int8 hidden
  and its pixel scales); with `terms`, the full-precision layer's products
  as `_conv_fp` computes them from TF32 parts."""
  t32 = _ln_bias(x, g, bln)
  if quantized:
    wuq, su, woq, so = qweights
    hidden = gelu(_conv_q8_patch(t32, wuq, su, bu))
    out, hq, hs = _conv_q8(hidden, woq, so, bo)
  else:
    hidden = gelu(_conv_fp(t32.to(x.dtype), wu, bu, terms=terms)).to(x.dtype)
    out = _conv_fp(hidden, wo, bo, terms=terms)
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


# Share of the hidden values that `fp_error_limit` lets the kernel and the
# plain version round a bf16 step apart on their own: the two sum conv_up's
# 9*C exact products in other orders (float32, about 1e-6 of the sum apart),
# and a hidden value within that distance of a rounding midpoint rounds the
# other way: 0.16% of them at the served widths (H100, PERF.md section 6).
# The share keeps a margin of 10 over it.
FP_HIDDEN_FLIP_SHARE = 1 / 64

# How far the kernel's LayerNorm output t32 may lie from the plain version's,
# in units of float32's unit roundoff (2^-24) of the terms it is made of (see
# `ln_noise`): both sum the C values and squares in other orders (a few
# roundings of the row's scale each) and take rsqrt to within 2 ulp.
FP_T32_NOISE_ROUNDINGS = 32


def _bf16_step(v: torch.Tensor) -> torch.Tensor:
  """The spacing of bfloat16 values at |v| (float32 in, float32 out): 2^-7
  of the power of two at or below |v|, read from the exponent bits."""
  a = v.float().abs().clamp_min(2.0**-126)
  return (a.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0**-7


def _bf16_midpoint_distance(v: torch.Tensor) -> torch.Tensor:
  """How far float32 v lies from the nearest point where its rounding to
  bfloat16 changes (a midpoint between two bf16 neighbours); exact."""
  a = v.float().abs()
  below = (a.view(torch.int32) & -65536).view(torch.float32)  # |v| truncated
  return ((a - below) - _bf16_step(a) / 2).abs()


def ln_noise(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
  """(t32 of `_ln_bias`, a bound [N, ..., C] on how far another float32
  single-pass LayerNorm of x may land from it): FP_T32_NOISE_ROUNDINGS
  roundings of |xhat * g| * E[x^2] / var (the variance's sums and rsqrt), of
  |g| * rsqrt(var) * rms(x) (the mean's sum) and of |t32| (the last add)."""
  xf = x.float()
  mu = xf.mean(-1, keepdim=True)
  ex2 = (xf * xf).mean(-1, keepdim=True)
  var = ex2 - mu * mu
  rs = torch.rsqrt(var + _EPS)
  xg = (xf - mu) * rs * g.float()
  t32 = xg + b.float()
  noise = (FP_T32_NOISE_ROUNDINGS * 2.0**-24) * (
      xg.abs() * ex2 / (var + _EPS) + g.float().abs() * rs * ex2.sqrt()
      + t32.abs())
  return t32, noise


def fp_error_limit(x, g, bln, wu, bu, wo, bo, unfused: bool = False):
  """Per-element limit [N, H, W, C] float32 on |kernel - plain| for the
  full-precision layer (with `unfused`, on |kernel - the model's unfused
  float layer|, below).

  float32: the port's 1e-4, absolute and relative. The kernel takes each
  product as three TF32 products of the operands' big and small parts
  (about 2^-22 of the product apart: the dropped A_small . B_small and the
  small parts' rounding), sums each K step's in the tensor cores and the
  steps in IEEE float32, in another order than the plain version's float32
  sums; `fp_padded_slab(terms="tf32x3")` emulates that within the limit
  at the served widths, and the limit refuses one TF32 product and the
  split without A_small . B_big (`fp32_controls`).

  bfloat16: both sides take conv products of the same bf16 values exactly
  and sum them in float32, so they differ where that noise makes a rounding
  to bf16 land a step apart, and the limit takes four deviations of what
  such steps do to the output, plus two bf16 steps of |y| (both round
  t32 + out separately). A hidden value a step s(h) apart moves out[p, col]
  by s(h) * wo[j, k, col] through tap j: with independent signs, the
  variance is a 3x3 convolution of the hidden's per-value variance with
  wo^2. Two sources: (1) on their own, a share FP_HIDDEN_FLIP_SHARE of the
  hidden values, variance share * s(h)^2; (2) a value of t a step apart: a
  t32 that lies within `ln_noise` of a bf16 rounding midpoint may round the
  other way in the kernel (about 5e-6 of them on the card), and shifts
  conv_up at the 9 pixels that read it by s(t) * wu[tap, c, k] in every
  hidden channel k: a fraction of a hidden step, which makes that fraction
  of the pixel's hidden values round the other way all at once. So hidden
  value k of pixel p moves by at most u = the sum over such t values in its
  3x3xC patch of s(t) * |wu[tap, c, k]|, rounds the other way with
  probability min(u / s(h), 1), and adds the variance min(u, s(h)) * s(h).

  `unfused`: `models.layers.ExtraConvs(quantized=False)` computes the same
  layer as plain bf16 convolutions, and rounds to bf16 at more points, each
  by at most half a step: each convolution's sum before its bias is added,
  and after; the GELU's output; the residual's t (not t32) and conv_out's
  output before they are added. So every hidden value may be apart by
  e = 1.13 * (s(up) + s(up + bu)) / 2 + s(h) / 2 (1.13 bounds GELU's
  slope; where the bias cancels the sum, s(up) is many hidden steps),
  which adds e^2 to each hidden value's variance (with a share of 1 for
  the flips), and the output by (s(t32) + s(out_conv) + s(out)) / 2 more.
  In float32 it rounds nowhere else, and the limit is the same.
  """
  if x.dtype != torch.bfloat16:
    y = extra_convs_layer_reference(x, g, bln, wu, bu, wo, bo, False)
    return 1e-4 * (1 + y.float().abs())
  wo2 = wo.to(x.dtype).float().square()
  wu_abs = wu.to(x.dtype).float().abs()
  share = 1.0 if unfused else FP_HIDDEN_FLIP_SHARE

  zero = lambda b: torch.zeros_like(b, dtype=torch.float32)

  def limit_of(v):
    t32, noise = ln_noise(v, g, bln)
    t = t32.to(v.dtype)
    up = _conv_fp(t, wu, zero(bu))
    hidden = gelu(up + bu.float()).to(v.dtype)
    out_conv = _conv_fp(hidden, wo, zero(bo))
    out = out_conv + bo.float()
    y = (t32 + out).to(v.dtype).float()
    step_h = _bf16_step(hidden.float())
    near = _bf16_midpoint_distance(t32) <= noise
    t_flips = torch.where(near, _bf16_step(t32), torch.zeros_like(t32))
    shift = torch.minimum(_conv_fp(t_flips, wu_abs, zero(bu)), step_h)
    per_value = share * step_h.square() + shift * step_h
    if unfused:
      e = (1.13 * (_bf16_step(up) + _bf16_step(up + bu.float())) + step_h) / 2
      per_value = per_value + e.square()
    limit = 4 * _conv_fp(per_value, wo2, zero(bo)).sqrt() + 2 * 2.0**-7 * y.abs()
    if unfused:
      limit = limit + (_bf16_step(t32) + _bf16_step(out_conv)
                       + _bf16_step(out)) / 2
    return limit

  return qconv.over_frames(limit_of, x, 3 * x.shape[-1] + 4 * bu.shape[0])


def fp_output_controls(x, g, bln, wu, bu, wo, bo):
  """Faulty versions of the plain full-precision layer on x, which
  `fp_error_limit` must refuse in float32: `unmasked_pad` lets the hidden of
  the pad ring (GELU of conv_up there, gelu(bu) and more) reach the edge
  pixels through conv_out, as the TPU kernel would without its mask;
  `bf16_t_residual` adds t rounded to bf16 where the residual takes t32 (in
  float32, t32 rounded to bf16); `hidden_precision` keeps the hidden in
  float32 in bf16 mode, and in float32 mode rounds it to bf16 (the mirror
  fault: the hidden in the other dtype than x's)."""
  dt = x.dtype
  t32 = _ln_bias(x, g, bln)
  t = t32.to(dt)
  up = gelu(_conv_fp(t, wu, bu))
  hidden = up.to(dt)
  out = _conv_fp(hidden, wo, bo)
  ring = F.pad(t, (0, 0, 1, 1, 1, 1))
  unmasked = _conv_fp(gelu(_conv_fp(ring, wu, bu)).to(dt), wo, bo, padding=0)
  other = up.bfloat16() if dt == torch.float32 else up
  wo_dt = wo.to(dt).float()
  return {
      "unmasked_pad": (t32 + unmasked).to(dt),
      "bf16_t_residual": (t32.bfloat16().float() + out).to(dt),
      "hidden_precision": (t32 + _conv_fp(other.float(), wo_dt, bo)).to(dt),
  }


def fp32_controls(x, g, bln, wu, bu, wo, bo):
  """Faulty float32 layers that `fp_error_limit` (1e-4) must refuse, as
  `fused_mixer_block.fp32_controls` are for K3: `single_tf32`, both
  convolutions in one TF32 product (on a CUDA tensor the plain layer with
  `torch.backends.cuda.matmul.allow_tf32` on; on the CPU float64 products of
  the operands rounded to TF32); `no_small_a`, the split without its
  A_small . B_big term (the activations rounded to TF32)."""
  width = 3 * (9 * x.shape[-1] + 4 * bu.shape[0])  # float64 parts

  def layer(terms):
    return qconv.over_frames(
        lambda v: _layer_reference(v, g, bln, wu, bu, wo, bo, False, None,
                                   terms=terms), x, width)

  if x.device.type == "cuda":
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
      single = extra_convs_layer_reference(x, g, bln, wu, bu, wo, bo, False)
    finally:
      torch.backends.cuda.matmul.allow_tf32 = before
  else:
    single = layer("single_tf32")
  return {"single_tf32": single, "no_small_a": layer("no_small_a")}


def fp_padded_slab(x, g, bln, wu, bu, wo, bo, terms=None):
  """The kernel's indexing of the full-precision layer (K6f), in float64
  products on the CPU. Arguments and result as
  `extra_convs_layer_reference(quantized=False)`, which this must equal up
  to float32 summation order. With `terms` (float32), the products are
  those of the operands' TF32 parts that `tma_gemm.TF32X3_TERMS[terms]`
  names: "tf32x3" is the float32 kernel's arithmetic with exact sums.

  t = T(t32) goes into zero-ringed frames viewed as rows [N (H+2) (W+2), C];
  conv_up is one GEMM over those rows (`qconv.slab_conv3x3`, K steps of
  `tma_gemm.K_BYTES` bytes of the model dtype), whose epilogue writes
  T(gelu(acc + bu)) on the rows inside their frame and zeros on the ring
  into the padded hidden; conv_out is one GEMM over the hidden's rows, and
  the rows inside their frame give y = T(t32 + (acc + bo)). Returns (y, the
  padded hidden [N, H+2, W+2, M])."""
  n, h, w, c = x.shape
  m = wu.shape[-1]
  dt = x.dtype
  step = tma_gemm.K_BYTES // x.element_size()

  def conv(slab, wt):
    pairs = ([(slab, wt)] if terms is None
             else tma_gemm.tf32x3_pairs(slab, wt, terms))
    return sum(qconv.slab_conv3x3(a, k, w + 2, step) for a, k in pairs).float()

  t32 = _ln_bias(x, g, bln)
  inside = torch.zeros(n, h + 2, w + 2, 1, dtype=torch.bool)
  inside[:, 1:h + 1, 1:w + 1] = True
  slab = F.pad(t32.to(dt), (0, 0, 1, 1, 1, 1)).reshape(-1, c)
  up = conv(slab, wu.to(dt).permute(3, 0, 1, 2)).reshape(n, h + 2, w + 2, m)
  hidden = torch.where(inside, gelu(up + bu.float()), 0.0).to(dt)
  out = conv(hidden.reshape(-1, m), wo.to(dt).permute(3, 0, 1, 2))
  out = out.reshape(n, h + 2, w + 2, c)[:, 1:h + 1, 1:w + 1]
  return (t32 + (out + bo.float())).to(dt), hidden


def fp_launch_plan(n, h, w, c, m, dtype=torch.bfloat16):
  """How K6f launches on x [n, h, w, c] with hidden width m in `dtype`.

  The LayerNorm writes t into zero-ringed frames `t_shape`; conv_up and
  conv_out are one GEMM each over the padded rows (`tma_gemm.gemm_plan`, 9
  taps of ceil(e C / 128) and ceil(e M / 128) K steps for e bytes a value),
  conv_up writing the padded hidden `hidden_shape`. bf16 on TILE_N-column
  tiles; float32 as error-compensated TF32 on TILE_N_TF32-column tiles,
  with the weights' big and small TF32 parts in a float32 scratch of
  `split_elements` values ([2, M, 9, C] for conv_up, then [2, C, 9, M]).
  `gemm_smem_bytes` is what the wrapper passes and the kernel checks.
  Raises for what the kernels do not take."""
  if dtype not in qconv.DTYPES:
    raise TypeError(
        f"extra_convs_layer: x must be float32 or bfloat16, got {dtype}")
  if min(n, h, w, c, m) <= 0:
    raise ValueError(f"extra_convs_layer: empty shape {(n, h, w, c)}, M={m}")
  if c % 16 or m % 16:
    raise ValueError(
        "extra_convs_layer: K6f needs C and the hidden width multiples of 16, "
        f"got {c} and {m}")
  padded = n * (h + 2) * (w + 2)
  if padded + w + 3 + tma_gemm.TILE_M > _INT32_MAX:
    raise ValueError(f"extra_convs_layer: {padded} padded rows overflow the "
                     "kernels' coordinates")
  fp32 = dtype == torch.float32
  elt = 4 if fp32 else 2
  tile_n = tma_gemm.TILE_N_TF32 if fp32 else tma_gemm.TILE_N
  k_bytes = lambda cin: 9 * -(-elt * cin // tma_gemm.K_BYTES) * tma_gemm.K_BYTES
  return dict(rows=n * h * w, padded_rows=padded, t_shape=(n, h + 2, w + 2, c),
              hidden_shape=(n, h + 2, w + 2, m),
              up=tma_gemm.gemm_plan(padded, m, k_bytes(c), tile_n=tile_n),
              out=tma_gemm.gemm_plan(padded, c, k_bytes(m), tile_n=tile_n),
              split_elements=4 * 9 * m * c if fp32 else 0,
              gemm_smem_bytes=tma_gemm.SMEM_BYTES)


def _launch_fp(x, g, bln, wu, bu, wo, bo, scratch=None):
  """K6f on the card. If `scratch` is a dict, the kernels' t32 [N, H, W, C]
  and hidden [N, H, W, M] are left in it, for checks (the hidden a view of
  the padded slab, which it holds too, as `hidden_padded`, beside t's,
  `t_padded`)."""
  global LAUNCHES_FP
  if x.dtype not in qconv.DTYPES:
    raise TypeError(
        f"extra_convs_layer: x must be float32 or bfloat16, got {x.dtype}")
  if x.ndim != 4 or not x.is_contiguous():
    raise ValueError("extra_convs_layer: x must be a contiguous [N, H, W, C]")
  n, h, w, c = x.shape
  m = wu.shape[-1]
  dev = x.device
  if tuple(wu.shape) != (3, 3, c, m) or tuple(wo.shape) != (3, 3, m, c):
    raise ValueError(
        f"extra_convs_layer: wu {tuple(wu.shape)} and wo {tuple(wo.shape)} "
        f"must be [3, 3, {c}, M] and [3, 3, M, {c}]")
  plan = fp_launch_plan(n, h, w, c, m, x.dtype)
  for name, p, size in (("g", g, c), ("bln", bln, c), ("bu", bu, m), ("bo", bo, c),
                        ("wu", wu, None), ("wo", wo, None)):
    if (size is not None and tuple(p.shape) != (size,)) or p.device != dev:
      raise ValueError(f"extra_convs_layer: {name} must be on {dev}"
                       + (f" with shape [{size}]" if size else ""))
  g32, bln32, bu32, bo32 = (p.float().contiguous() for p in (g, bln, bu, bo))
  # OHWI, in x.dtype: row o of [M, 9C] is output channel o, k = tap*C + c.
  wu_t = wu.to(x.dtype).permute(3, 0, 1, 2).contiguous()
  wo_t = wo.to(x.dtype).permute(3, 0, 1, 2).contiguous()

  lib = _build.load("extra_convs", qconv.SIGNATURES)
  t32 = torch.empty((plan["rows"], c), dtype=torch.float32, device=dev)
  t = torch.empty(plan["t_shape"], dtype=x.dtype, device=dev)
  hidden = torch.empty(plan["hidden_shape"], dtype=x.dtype, device=dev)
  # float32: the weights' big and small TF32 parts.
  wsplit = (torch.empty((plan["split_elements"],), dtype=torch.float32,
                        device=dev) if plan["split_elements"] else None)
  out = torch.empty_like(x)
  operands = (x, g32, bln32, wu_t, bu32, wo_t, bo32, t32, t, hidden, wsplit,
              out)
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = lib.extra_convs_fp_forward(
        *[None if o is None else o.data_ptr() for o in operands], n, h, w, c,
        m, plan["gemm_smem_bytes"], qconv.DTYPES[x.dtype], stream,
    )
  _build.check(lib, err, "extra_convs_fp_forward")
  LAUNCHES_FP += 1
  if scratch is not None:
    scratch.update(t32=t32.view(n, h, w, c), hidden=hidden[:, 1:h + 1, 1:w + 1],
                   hidden_padded=hidden, t_padded=t)
  return out


# K6's launch plan, as csrc/extra_convs.cu launches it (kUpRows, kUpCols,
# kUpStages, kOutRows, kOutCols, kOutStages, up_smem_bytes, out_smem_bytes):
# conv_up takes 64 output pixels per CTA with their quantized 3x3xC patches
# resident in shared memory and walks all M columns in steps of 128 (twice:
# the hidden's amax, then its int8 values), alternate steps to each of its two
# warpgroups, each with a ring of one-panel stages of its own; conv_out takes
# 128 x 128 tiles with both operands through one ring. The kernels refuse a
# plan whose shared memory differs from their own count.
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100
THREADS = 256
_PANEL = 64  # bytes of K per panel row (csrc/q8_tile.cuh)
_SMEM_ALIGN = 1024  # slack to align the panels (csrc/q8_tile.cuh)
_UP_ROWS, _UP_COLS, _UP_STAGES = 64, 128, 5
_OUT_ROWS, _OUT_COLS, _OUT_STAGES = 128, 128, 6
_INT32_MAX = 2**31 - 1


def q8_launch_plan(n, h, w, c, m, dtype=torch.bfloat16):
  """How K6 launches on x [n, h, w, c] with hidden width m in `dtype`: the
  rows per block, dynamic shared-memory bytes, grid and ring stages of
  conv_up and conv_out. Raises for what the kernels do not take."""
  if dtype not in qconv.DTYPES:
    raise TypeError(
        f"extra_convs_layer: x must be float32 or bfloat16, got {dtype}")
  if min(n, h, w, c, m) <= 0:
    raise ValueError(f"extra_convs_layer: empty shape {(n, h, w, c)}, M={m}")
  if c % 16 or m % 64:
    raise ValueError(
        "extra_convs_layer: K6 needs C a multiple of 16 and the hidden width "
        f"a multiple of 64, got {c} and {m}")
  rows = n * h * w
  if rows + _OUT_ROWS > _INT32_MAX:
    raise ValueError(f"extra_convs_layer: {rows} pixels overflow the kernels' "
                     "32-bit pixel index")
  panels = -(-9 * c // _PANEL)
  up_smem = (_SMEM_ALIGN + panels * _UP_ROWS * _PANEL
             + 2 * _UP_STAGES * _UP_COLS * _PANEL + _UP_ROWS * 4 * (1 + 2)
             + _UP_ROWS * 4 * 2)
  out_smem = (_SMEM_ALIGN + _OUT_STAGES * (_OUT_ROWS + _OUT_COLS) * _PANEL
              + _OUT_ROWS * 4 * 2)
  if up_smem > SMEM_LIMIT:
    raise ValueError(
        f"extra_convs_layer: K6's conv_up keeps a 64-pixel block's 3x3x{c} "
        f"patch in shared memory: {up_smem} bytes with its ring, over the "
        f"{SMEM_LIMIT} a block may use (C <= 256 fits)")
  return dict(
      rows=rows,
      up=dict(rows_per_block=_UP_ROWS, cols_per_step=_UP_COLS,
              smem_bytes=up_smem, grid=-(-rows // _UP_ROWS),
              stages=_UP_STAGES, threads=THREADS),
      out=dict(rows_per_block=_OUT_ROWS, cols_per_block=_OUT_COLS,
               smem_bytes=out_smem,
               grid=-(-rows // _OUT_ROWS) * -(-c // _OUT_COLS),
               stages=_OUT_STAGES, threads=THREADS),
  )


def _launch(x, g, bln, bu, bo, qweights, scratch=None):
  """K6 on the card. If `scratch` is a dict, the kernels' intermediates are
  left in it (t32, the patch scales, the float32 hidden that conv_up
  quantizes, the int8 hidden and its pixel scales), for checks; without it
  no float32 hidden exists."""
  global LAUNCHES
  if x.ndim != 4 or not x.is_contiguous():
    raise ValueError("extra_convs_layer: x must be a contiguous [N, H, W, C]")
  n, h, w, c = x.shape
  wuq, su, woq, so = qweights
  m = wuq.shape[0]
  plan = q8_launch_plan(n, h, w, c, m, x.dtype)
  dev = x.device
  qconv._check_int8_conv_weights("extra_convs_layer", wuq, su, c, dev)  # pylint: disable=protected-access
  qconv._check_int8_conv_weights("extra_convs_layer", woq, so, m, dev)  # pylint: disable=protected-access
  if woq.shape[0] != c:
    raise ValueError(f"extra_convs_layer: conv_out has {woq.shape[0]} outputs, x {c}")
  for name, p, size in (("g", g, c), ("bln", bln, c), ("bu", bu, m), ("bo", bo, c)):
    if tuple(p.shape) != (size,) or p.device != dev:
      raise ValueError(f"extra_convs_layer: {name} must be [{size}] on {dev}")
  g32, bln32, bu32, bo32 = (p.float().contiguous() for p in (g, bln, bu, bo))

  lib = _build.load("extra_convs", qconv.SIGNATURES)
  rows = plan["rows"]
  f32 = dict(dtype=torch.float32, device=dev)
  t32 = torch.empty((rows, c), **f32)
  pixel_amax = torch.empty((rows,), **f32)
  patch_scale = torch.empty((rows,), **f32)
  hidden = None if scratch is None else torch.empty((rows, m), **f32)
  hq = torch.empty((rows, m), dtype=torch.int8, device=dev)
  hs = torch.empty((rows,), **f32)
  out = torch.empty_like(x)
  ptr = lambda o: None if o is None else o.data_ptr()
  operands = (x, g32, bln32, wuq, su, bu32, woq, so, bo32, t32, pixel_amax,
              patch_scale, hidden, hq, hs, out)
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = lib.extra_convs_q8_pixel_forward(
        *[ptr(o) for o in operands], n, h, w, c, m, plan["up"]["smem_bytes"],
        plan["out"]["smem_bytes"], qconv.DTYPES[x.dtype], stream,
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
    quantized: the per-pixel w8a8 scheme (see module docstring); False is
      the full-precision layer (K6f on the card).
    qweights: with `quantized`, `quantized_weights(wu, wo)` made once by the
      caller; wu and wo are then not read and may be None.

  Returns:
    [N, H, W, C] in x.dtype.

  Differentiable in every tensor argument on every device: the backward is
  the VJP of the full-precision `extra_convs_layer_reference` recomputed
  from the inputs (JAX's `_bwd`), straight-through for `quantized`
  (`ops._vjp`); a quantized layer needs wu and wo then.
  """
  if x.device.type not in ("cpu", "cuda"):
    raise ValueError(f"extra_convs_layer: unsupported device {x.device}")

  def forward(*args):
    return _forward(*args, quantized, qweights)

  def plain(*args):
    if args[3] is None or args[5] is None:
      raise ValueError("extra_convs_layer: its gradient needs wu and wo")
    return extra_convs_layer_reference(*args, quantized=False)

  return _vjp.apply(forward, plain, x, g, bln, wu, bu, wo, bo)


def _forward(x, g, bln, wu, bu, wo, bo, quantized, qweights):
  """`extra_convs_layer` without its gradient: the kernels on CUDA tensors,
  the plain version on CPU tensors."""
  if x.device.type == "cpu":
    return extra_convs_layer_reference(x, g, bln, wu, bu, wo, bo, quantized,
                                       qweights)
  if x.device.type == "cuda":
    if not quantized:
      return _launch_fp(x.contiguous(), g, bln, wu, bu, wo, bo)
    if qweights is None:
      qweights = quantized_weights(wu, wo)
    return _launch(x.contiguous(), g, bln, bu, bo, qweights)
  raise ValueError(f"extra_convs_layer: unsupported device {x.device}")
