"""Convolutions of the backbone: full precision, and the w8a8 int8 3x3 one.

Port of tapnet_tpu/ops/qconv.py. Layouts are PyTorch's (NCHW activations,
OIHW weights); the port's activations are channels-last tensors, so an NCHW
activation is NHWC in memory, which is what the int8 kernel reads.

`conv2d_fp_math` is XLA's convolution in the JAX package, not a Pallas
kernel, so it stays `F.conv2d`. Flax "SAME" pads asymmetrically when the
stride does not divide the input: for a 3x3 stride-2 conv on an even input it
pads 0 before and 1 after; for the 7x7 stride-2 stem, 2 and 3.
`F.conv2d(padding=...)` is symmetric, so such cases take an explicit `F.pad`.

`conv2d_q8` is the per-frame int8 convolution of the ExtraConvs
(`quantized_extra_convs=True`; JAX: `conv2d_q8_math`, XLA's int8
convolution): symmetric per-output-channel weight scales, one activation
scale per frame (the amax over H, W and C of each image), int32
accumulation, dequantization `acc * (xs * ws) + b` in float32, output in
x.dtype. Only the SAME 3x3 stride-1 form that the ExtraConvs use is ported.

  * CPU tensors run `conv2d_q8_math`, the plain version: the int8 products
    as float64 matrix products of the int8 values, which hold every partial
    sum (at most 9 * C_in * 127^2) exactly, in any order.
  * CUDA tensors launch `conv3x3_q8_frame_forward` of
    `csrc/extra_convs.cu` (frame amax, quantization into zero-padded
    frames, and the convolution as one int8 GEMM over the padded raster on
    the TMA + wgmma loop of `csrc/tma_gemm.cuh`; `conv2d_q8_padded_slab`
    emulates its indexing). PyTorch has no int8 convolution on CUDA.
  * Anything else raises. There is no size gate and no fallback.

The ExtraConvs quantizers divide: q = clip(round(v / s), -127, 127) with
s = max(amax, 1e-8) * (1 / 127), rounding half to even. The mixer's
quantizer (`mixer_math.quantize_rows`) multiplies by 127 / amax instead; the
two differ in the last bit at half steps, so they are not interchangeable.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.ops import _build, _vjp, tma_gemm

# Number of CUDA launches of the per-frame int8 convolution made through
# `conv2d_q8` (one per call: its three kernels count once).
LAUNCHES_Q8 = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Entry points of csrc/extra_convs.cu, for `_build.load`.
SIGNATURES = {
    "conv3x3_q8_frame_forward": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "extra_convs_q8_pixel_forward": [ctypes.c_void_p] * 16
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "extra_convs_fp_forward": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}

# The taps of a 3x3 SAME convolution, in the order of the weights' (kh, kw)
# axes: tap j = (dy + 1) * 3 + (dx + 1) reads the input at (y + dy, x + dx).
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# The plain int8 versions work on frame chunks of at most this many float64
# elements per intermediate: frames are independent, and at the served shapes
# on the card a whole batch's float64 patches would take tens of gigabytes.
_CHUNK_ELEMENTS = 1 << 27


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(before, after) padding of one axis under XLA's SAME rule."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def conv2d_fp_math(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
  """SAME conv (+ bias), IO and weights in x.dtype.

  Args:
    x: [N, C_in, H, W].
    weight: [C_out, C_in, kh, kw].
    bias: optional [C_out].
    stride: spatial stride.
  """
  kh, kw = weight.shape[2:]
  top, bottom = same_padding(x.shape[2], kh, stride)
  left, right = same_padding(x.shape[3], kw, stride)
  weight = weight.to(x.dtype)
  bias = None if bias is None else bias.to(x.dtype)
  if top == bottom and left == right:
    return F.conv2d(x, weight, bias, stride=stride, padding=(top, left))
  x = F.pad(x, (left, right, top, bottom))
  return F.conv2d(x, weight, bias, stride=stride)


# ----------------------------------------------------------- int8 quantizers


def quantize_symmetric(v: torch.Tensor, amax: torch.Tensor):
  """(clip(round(v / s), -127, 127) int8, s float32) with
  s = max(amax, 1e-8) * (1 / 127); `amax` broadcasts against v."""
  scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
  q = torch.clamp(torch.round(v / scale), -127.0, 127.0)
  return q.to(torch.int8), scale


def quantize_conv_weight(weight: torch.Tensor):
  """Per-output-channel int8 quantization of an OIHW conv weight.

  Returns (q int8 [C_out, kh, kw, C_in] contiguous, the layout the kernels
  read: each output channel's taps and input channels in one row; scale
  float32 [C_out]).
  """
  wf = weight.float()
  q, scale = quantize_symmetric(wf, wf.abs().amax((1, 2, 3), keepdim=True))
  return q.permute(0, 2, 3, 1).contiguous(), scale.reshape(-1)


def quantize_per_frame(x: torch.Tensor):
  """One scale per leading index: [N, ...] -> (int8 [N, ...], float32 [N])."""
  xf = x.float()
  dims = tuple(range(1, x.ndim))
  q, scale = quantize_symmetric(xf, xf.abs().amax(dims, keepdim=True))
  return q, scale.reshape(-1)


# ------------------------------------------------------ plain int8 pieces


def shifted(v: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
  """Zero-boundary shift of [N, H, W, C]: out[:, y, x] = v[:, y + dy, x + dx]."""
  h, w = v.shape[1:3]
  padded = F.pad(v, (0, 0, 1, 1, 1, 1))
  return padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def int8_tap_products(q: torch.Tensor, wq: torch.Tensor):
  """Per tap of a SAME 3x3 convolution, the exact integer product.

  q: int8 [N, H, W, C_in]; wq: int8 [C_out, 3, 3, C_in]. Yields float64
  [N, H, W, C_out] holding shifted(q, tap) . wq[:, tap]^T exactly, in the
  order of TAPS.
  """
  qd = q.double()
  for dy, dx in TAPS:
    w_tap = wq[:, dy + 1, dx + 1].double()
    yield torch.matmul(shifted(qd, dy, dx), w_tap.t())


def over_frames(fn: Callable, x: torch.Tensor, per_pixel_elements: int):
  """fn over frame chunks of x [N, H, W, ...], concatenated along the first
  axis (each of fn's outputs, if it returns a tuple): chunks of at most
  _CHUNK_ELEMENTS, for an fn whose intermediates take `per_pixel_elements`
  float64 elements per pixel."""
  per_frame = x.shape[1] * x.shape[2] * per_pixel_elements
  step = max(1, _CHUNK_ELEMENTS // per_frame)
  if step >= x.shape[0]:
    return fn(x)
  parts = [fn(x[i : i + step]) for i in range(0, x.shape[0], step)]
  if isinstance(parts[0], tuple):
    return tuple(torch.cat(group) for group in zip(*parts))
  return torch.cat(parts)


def _conv2d_q8_nhwc(x, wq, ws, bias):
  xq, xs = quantize_per_frame(x)
  acc = sum(int8_tap_products(xq, wq))  # exact in float64
  y = acc.float() * (xs[:, None, None, None] * ws) + bias.float()
  return y.to(x.dtype)


def conv2d_q8_math(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: torch.Tensor,
    qweights=None,
) -> torch.Tensor:
  """Plain version of the per-frame w8a8 SAME 3x3 stride-1 convolution.

  Args:
    x: [N, C_in, H, W] activations, float32 or bfloat16.
    weight: [C_out, C_in, 3, 3] full-precision weights (not read when
      `qweights` is given).
    bias: [C_out].
    qweights: optional (int8 [C_out, 3, 3, C_in], float32 [C_out]) from
      `quantize_conv_weight`, so a module quantizes once.

  Returns:
    [N, C_out, H, W] in x.dtype (a channels-last tensor).
  """
  wq, ws = qweights if qweights is not None else quantize_conv_weight(weight)
  nhwc = x.permute(0, 2, 3, 1)
  y = over_frames(lambda v: _conv2d_q8_nhwc(v, wq, ws, bias), nhwc,
                  nhwc.shape[-1] + 2 * wq.shape[0])
  return y.permute(0, 3, 1, 2)


def slab_conv3x3(slab: torch.Tensor, w: torch.Tensor, wp: int,
                 step: int) -> torch.Tensor:
  """A 3x3 convolution over padded frames as the CUDA kernels on
  `csrc/tma_gemm.cuh` run it (X, K6f), in float64: slab [rows,
  cin] holds the frames with their zero ring as rows (wp = W + 2 a row),
  w is [cout, 3, 3, cin]. GEMM row p' sums, over the taps (dy, dx) and K
  steps of `step` channels (zeros past cin), the rows p' + dy wp + dx of the
  slab (zeros outside it, as TMA fills a box) times the tap's weights.
  Returns float64 [rows, cout]; rows of the ring read across frames."""
  rows, cin = slab.shape
  cpad = -(-cin // step) * step
  slab = F.pad(slab.double(), (0, cpad - cin))
  w = F.pad(w.double(), (0, cpad - cin))
  acc = torch.zeros(rows, w.shape[0], dtype=torch.float64)
  for dy, dx in TAPS:
    src = torch.arange(rows) + dy * wp + dx
    inside = (src >= 0) & (src < rows)
    for c0 in range(0, cpad, step):
      box = torch.zeros(rows, step, dtype=torch.float64)
      box[inside] = slab[src[inside], c0:c0 + step]
      acc += box @ w[:, dy + 1, dx + 1, c0:c0 + step].t()
  return acc


def conv2d_q8_padded_slab(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: torch.Tensor,
    qweights=None,
) -> torch.Tensor:
  """The CUDA kernel's indexing of the per-frame int8 conv, in float64.

  Arguments and result as `conv2d_q8_math`, which this must equal exactly.
  The int8 frames are padded with a zero ring to [N, H+2, W+2, C_in] and
  viewed as rows [N (H+2) (W+2), C_in], convolved by `slab_conv3x3` in K
  steps of `tma_gemm.K_BYTES` channels; the rows inside their frame are the
  output. Rows of the ring read across frames and are dropped.
  """
  wq, ws = qweights if qweights is not None else quantize_conv_weight(weight)
  nhwc = x.permute(0, 2, 3, 1)
  n, h, w, cin = nhwc.shape
  xq, xs = quantize_per_frame(nhwc)
  slab = F.pad(xq.double(), (0, 0, 1, 1, 1, 1)).reshape(-1, cin)
  acc = slab_conv3x3(slab, wq, w + 2, tma_gemm.K_BYTES)
  acc = acc.reshape(n, h + 2, w + 2, -1)[:, 1:h + 1, 1:w + 1]
  y = acc.float() * (xs[:, None, None, None] * ws) + bias.float()
  return y.to(x.dtype).permute(0, 3, 1, 2)


# ------------------------------------------------------------- CUDA kernel


def q8_frame_launch_plan(n, h, w, cin, cout, dtype=torch.bfloat16):
  """How `conv3x3_q8_frame_forward` launches on x [n, h, w, cin] with cout
  output channels: the padded int8 frames it writes, and the GEMM over
  their rows (`tma_gemm.gemm_plan`: 9 * ceil(cin / 128) K steps). Raises
  for what the kernels do not take."""
  if dtype not in DTYPES:
    raise TypeError(f"conv2d_q8: x must be float32 or bfloat16, got {dtype}")
  if min(n, h, w, cin, cout) <= 0:
    raise ValueError(f"conv2d_q8: empty shape {(n, h, w, cin)} -> {cout}")
  if cin % 16 or cout % 16:
    raise ValueError(
        f"conv2d_q8: the int8 kernel needs C_in and C_out multiples of 16, "
        f"got {cin} and {cout}")
  rows = n * (h + 2) * (w + 2)
  if rows + w + 3 + tma_gemm.TILE_M > tma_gemm.INT32_MAX:
    raise ValueError(f"conv2d_q8: {rows} padded rows overflow the kernel's "
                     "coordinates")
  per_tap = -(-cin // tma_gemm.K_BYTES)
  return dict(
      xq_shape=(n, h + 2, w + 2, cin), padded_rows=rows,
      gemm=tma_gemm.gemm_plan(rows, cout, 9 * per_tap * tma_gemm.K_BYTES),
  )




def _check_int8_conv_weights(name, wq, ws, cin, dev):
  cout = wq.shape[0]
  if (wq.dtype != torch.int8 or tuple(wq.shape) != (cout, 3, 3, cin)
      or not wq.is_contiguous() or wq.device != dev):
    raise ValueError(
        f"{name}: int8 weight is {tuple(wq.shape)} {wq.dtype} on {wq.device}, "
        f"expected a contiguous ({cout}, 3, 3, {cin}) int8 tensor on {dev}")
  if ws.dtype != torch.float32 or tuple(ws.shape) != (cout,) or ws.device != dev:
    raise ValueError(f"{name}: weight scale must be float32 [{cout}] on {dev}")


def _launch_q8(x, qweights, bias, scratch=None):
  """The per-frame int8 conv on the card. If `scratch` is a dict, the kernels'
  int8 operand (`xq` [N, H, W, C_in], a view of `xq_padded` [N, H+2, W+2,
  C_in]) and frame scales `xs` are left in it, for checks."""
  global LAUNCHES_Q8
  if x.dtype not in DTYPES:
    raise TypeError(f"conv2d_q8: x must be float32 or bfloat16, got {x.dtype}")
  wq, ws = qweights
  nhwc = x.permute(0, 2, 3, 1).contiguous()
  if nhwc.data_ptr() % 16:  # the quantizer reads 16-byte pieces
    nhwc = nhwc.clone()
  n, h, w, cin = nhwc.shape
  cout = wq.shape[0]
  dev = x.device
  _check_int8_conv_weights("conv2d_q8", wq, ws, cin, dev)
  plan = q8_frame_launch_plan(n, h, w, cin, cout, x.dtype)
  if tuple(bias.shape) != (cout,) or bias.device != dev:
    raise ValueError(f"conv2d_q8: bias must be [{cout}] on {dev}")
  if wq.data_ptr() % 16:
    raise ValueError("conv2d_q8: the int8 weight must be 16-byte aligned")
  lib = _build.load("extra_convs", SIGNATURES)
  amax = torch.empty((n,), dtype=torch.int32, device=dev)
  xq = torch.empty(plan["xq_shape"], dtype=torch.int8, device=dev)
  xs = torch.empty((n,), dtype=torch.float32, device=dev)
  out = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
  bias32 = bias.float().contiguous()
  stream = torch.cuda.current_stream(dev).cuda_stream
  with torch.cuda.device(dev):
    err = lib.conv3x3_q8_frame_forward(
        *[o.data_ptr() for o in (nhwc, wq, ws, bias32, amax, xq, xs, out)],
        n, h, w, cin, cout, plan["gemm"]["smem_bytes"], DTYPES[x.dtype],
        stream,
    )
  _build.check(lib, err, "conv3x3_q8_frame_forward")
  LAUNCHES_Q8 += 1
  if scratch is not None:
    scratch.update(xq=xq[:, 1:-1, 1:-1], xq_padded=xq, xs=xs)
  return out.permute(0, 3, 1, 2)


def conv2d_q8(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: torch.Tensor,
    qweights=None,
) -> torch.Tensor:
  """Per-frame w8a8 SAME 3x3 stride-1 convolution (see module docstring).

  Arguments as `conv2d_q8_math`. Returns [N, C_out, H, W] in x.dtype.

  Differentiable in x, weight and bias on every device, straight-through:
  the backward is the VJP of `conv2d_fp_math` recomputed from the inputs
  (JAX's `_q8_bwd`, `ops._vjp`); it needs `weight` then.
  """
  if x.device.type not in ("cpu", "cuda"):
    raise ValueError(f"conv2d_q8: unsupported device {x.device}")

  def plain(x, weight, bias):
    if weight is None:
      raise ValueError("conv2d_q8: its gradient needs the float weight")
    return conv2d_fp_math(x, weight, bias)

  return _vjp.apply(lambda *args: _forward(*args, qweights), plain,
                    x, weight, bias)


def _forward(x, weight, bias, qweights):
  """`conv2d_q8` without its gradient: the kernel on CUDA tensors, the plain
  version on CPU tensors."""
  if x.device.type == "cpu":
    return conv2d_q8_math(x, weight, bias, qweights)
  if x.device.type == "cuda":
    if qweights is None:
      qweights = quantize_conv_weight(weight)
    return _launch_q8(x, qweights, bias)
  raise ValueError(f"conv2d_q8: unsupported device {x.device}")
