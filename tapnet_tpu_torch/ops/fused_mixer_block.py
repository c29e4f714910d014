"""One PIPs-mixer block (port of tapnet_tpu/ops/fused_mixer_block.py).

    x += temporal_depthwise(LN1(x));  x += MLP(LN2(x))

`mixer_block` keeps the JAX public layout: x [B, T, C]; g1, g2 [C];
depthwise kernels wu, wm [k, 1, mult*C] (c-major) with biases [mult*C];
w1 [C, H], b1 [H], w2 [H, C], b2 [C].

  * CPU tensors run `mixer_block_reference`, the port of the JAX
    `_math_reference`.
  * CUDA tensors launch the hand-written kernels of
    `csrc/fused_mixer_block.cu` (temporal half + LN2, then the two MLP
    products). The dense weights are passed to it in Linear's [out, in]
    layout: for the transposed view of a Linear weight that `w1.t()` gives,
    that is the weight's own storage, so no copy is made.
  * Anything else raises. There is no size gate and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.ops import _build, mixer_math

# Number of CUDA launches of the block kernel made through `mixer_block`.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mixer_block_forward": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
}


def _reference_parts(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal,
                     valid_len):
  """The plain block's temporal output h, x1 = x + h and out = x1 + MLP(x1),
  each [B, valid_len, C] in x.dtype."""
  if valid_len is not None and valid_len != x.shape[1]:
    x = x[:, :valid_len]
  h = mixer_math.temporal_depthwise_math(
      mixer_math.layer_norm(x, g1), wu, bu, wm, bm, causal
  )
  x1 = x + h
  b, t, c = x1.shape
  out = mixer_math.mlp_math(x1.reshape(b * t, c), g2, w1, b1, w2, b2)
  return h, x1, out.reshape(b, t, c)


def mixer_block_reference(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None,
):
  """Plain version of the whole block. x: [B, T, C].

  With `valid_len`, rows >= valid_len are padding: ignored on input and
  exactly zero on output.
  """
  _, _, y = _reference_parts(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2,
                             causal, valid_len)
  return F.pad(y, (0, 0, 0, x.shape[1] - y.shape[1]))


def bf16_error_limit(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None,
):
  """Per-element limit [B, T, C] float32 on |kernel - plain| in bf16.

  The kernel keeps LN1's output in float32, as the TPU kernel does; the
  plain version rounds it to bf16, as the JAX reference does. Both round the
  temporal output h, x1 = x + h, the MLP's operand and hidden, and
  out = x1 + y to bf16, so the small differences before each rounding can
  leave the two results a bf16 step apart there (a step at v is at most
  2^-7 |v|): at |h|, |x1| and |out|, and, through the MLP's rounded operand
  and hidden, at the row's rms of y. The limit is two steps of each (a
  headroom of 2 over one step). Rows >= valid_len get limit 0: both sides
  write exact zeros there.
  """
  h, x1, out = (
      v.float() for v in _reference_parts(
          x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len)
  )
  y_rms = (out - x1).square().mean(-1, keepdim=True).sqrt()
  limit = 2 * 2.0**-7 * (h.abs() + x1.abs() + out.abs() + y_rms)
  return F.pad(limit, (0, 0, 0, x.shape[1] - limit.shape[1]))


def _launch(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len):
  global LAUNCHES
  if x.dtype not in _DTYPES:
    raise TypeError(f"mixer_block: x must be float32 or bfloat16, got {x.dtype}")
  b, t, c = x.shape
  k = wu.shape[0]
  mult = wu.shape[-1] // c
  hid = w1.shape[1]
  if k != 3:
    raise ValueError(f"The CUDA mixer-block kernel is built for k=3, got {k}.")
  expected = {
      "g1": (c,), "wu": (k, 1, mult * c), "bu": (mult * c,),
      "wm": (k, 1, mult * c), "bm": (mult * c,), "g2": (c,),
      "w1": (c, hid), "b1": (hid,), "w2": (hid, c), "b2": (c,),
  }
  params = dict(g1=g1, wu=wu, bu=bu, wm=wm, bm=bm, g2=g2, w1=w1, b1=b1,
                w2=w2, b2=b2)
  for name, shape in expected.items():
    p = params[name]
    if tuple(p.shape) != shape or p.dtype != x.dtype or p.device != x.device:
      raise ValueError(
          f"mixer_block: {name} is {tuple(p.shape)} {p.dtype} on {p.device}, "
          f"expected {shape} {x.dtype} on {x.device}"
      )
  if x.dtype == torch.bfloat16 and (c % 8 or hid % 8):
    raise ValueError("mixer_block: bf16 kernel needs C and H multiples of 8")
  t_real = t if valid_len is None else int(valid_len)
  if not 0 <= t_real <= t:
    raise ValueError(f"mixer_block: valid_len {valid_len} outside [0, {t}]")
  # Linear layout [out, in]: a view back onto the Linear weight's storage.
  w1_t = w1.t().contiguous()
  w2_t = w2.t().contiguous()
  operands = [x, g1, wu, bu, wm, bm, g2, w1_t, b1, w2_t, b2]
  if not all(o.is_contiguous() for o in operands):
    raise ValueError("mixer_block: x and the block parameters must be contiguous")
  if x.dtype == torch.bfloat16 and any(o.data_ptr() % 16 for o in (w1_t, w2_t)):
    raise ValueError("mixer_block: bf16 weights must be 16-byte aligned")

  lib = _build.load("fused_mixer_block", _SIGNATURES)
  x1 = torch.empty_like(x)
  mlp_in = torch.empty_like(x)
  hidden = torch.empty((b * t, hid), dtype=x.dtype, device=x.device)
  out = torch.empty_like(x)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  with torch.cuda.device(x.device):
    err = lib.mixer_block_forward(
        *[o.data_ptr() for o in operands],
        x1.data_ptr(), mlp_in.data_ptr(), hidden.data_ptr(), out.data_ptr(),
        b, t, t_real, c, hid, mult, k, int(bool(causal)), _DTYPES[x.dtype],
        stream,
    )
  _build.check(lib, err, "mixer_block_forward")
  LAUNCHES += 1
  return out


def mixer_block(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None,
):
  """Mixer block: x += dwconv(LN(x)); x += MLP(LN(x)).

  Args:
    x: [B, T, C] trajectories.
    g1 / g2: [C] LayerNorm scales (temporal / channel).
    wu / wm: [k, 1, mult*C] depthwise conv kernels (conv layout, c-major).
    bu / bm: [mult*C] depthwise conv biases.
    w1: [C, H]; b1: [H]; w2: [H, C]; b2: [C] channel-MLP params.
    causal: causal (left-only) vs SAME temporal padding.
    valid_len: if set, rows >= valid_len are padding: ignored on input,
      exactly zero on output.

  Returns:
    [B, T, C], same dtype as x.
  """
  if x.device.type == "cpu":
    return mixer_block_reference(
        x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len
    )
  if x.device.type == "cuda":
    return _launch(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal,
                   valid_len)
  raise ValueError(f"mixer_block: unsupported device {x.device}")
