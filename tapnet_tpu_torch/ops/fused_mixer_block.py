"""One PIPs-mixer block (port of tapnet_tpu/ops/fused_mixer_block.py).

    x += temporal_depthwise(LN1(x));  x += MLP(LN2(x))

`mixer_block` keeps the JAX public layout: x [B, T, C]; g1, g2 [C];
depthwise kernels wu, wm [k, 1, mult*C] (c-major) with biases [mult*C];
w1 [C, H], b1 [H], w2 [H, C], b2 [C].

  * CPU tensors run `mixer_block_reference`, the port of the JAX
    `_math_reference`.
  * CUDA tensors launch the hand-written kernels of
    `csrc/fused_mixer_block.cu` (temporal half + LN2, then the two MLP
    products on the TMA + wgmma loop of `csrc/tma_gemm.cuh`, plan in
    `launch_plan`: bf16 products in bf16, float32 ones as error-compensated
    TF32, three tensor-core products of the operands' big and small TF32
    parts, `tf32x3_matmul` below). The dense weights are passed to it in
    Linear's [out, in] layout, K-major as TMA reads them: for the transposed
    view of a Linear weight that `w1.t()` gives (what `layers.MixerBlock`
    passes), that is the weight's own storage, so no copy is made; any other
    layout is copied into it for the call (`_linear_layout`). In float32 the
    kernel splits them into a scratch tensor of this call.
  * Anything else raises. There is no size gate and no fallback.

`quantized=True` runs the channel MLP in w8a8 int8 (`mixer_math.mlp_math_q8`):
the temporal half stays in full precision, LN2's float32 output is quantized
per row, both products are int8 x int8 -> int32, the hidden is quantized per
row from its float32 value, and dequantization, bias, GELU and the residual
are float32. The caller passes the weights already quantized
(`mixer_math.quantize_weight_cols`) as `qweights=(w1q, s1, w2q, s2)`, so a
module quantizes them once and not per call; without `qweights` they are
quantized here. On CUDA tensors this is the kernel `mixer_block_q8_forward`
of the same source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.ops import _build, _vjp, mixer_math, tma_gemm

# Number of CUDA launches of the block kernel made through `mixer_block`:
# the full-precision block, and the block with the w8a8 channel MLP.
LAUNCHES = 0
LAUNCHES_Q8 = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_SIGNATURES = {
    "mixer_block_forward": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "mixer_block_q8_forward": [ctypes.c_void_p] * 20 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
}


def _quantized_weights(w1, w2, qweights):
  """(w1q [C, H], s1 [H], w2q [H, C], s2 [C]): `qweights`, or w1 and w2
  quantized per output column."""
  if qweights is not None:
    return qweights
  return (*mixer_math.quantize_weight_cols(w1),
          *mixer_math.quantize_weight_cols(w2))


def _reference_parts(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal,
                     valid_len, quantized=False, qweights=None,
                     matmul=torch.matmul):
  """The plain block's temporal output h, x1 = x + h and out = x1 + MLP(x1),
  each [B, valid_len, C] in x.dtype; `matmul`: the full-precision MLP's
  product (`mixer_math.mlp_math`)."""
  if valid_len is not None and valid_len != x.shape[1]:
    x = x[:, :valid_len]
  h = mixer_math.temporal_depthwise_math(
      mixer_math.layer_norm(x, g1), wu, bu, wm, bm, causal
  )
  x1 = x + h
  b, t, c = x1.shape
  rows = x1.reshape(b * t, c)
  if quantized:
    w1q, s1, w2q, s2 = _quantized_weights(w1, w2, qweights)
    out = mixer_math.mlp_math_q8(rows, g2, w1q, s1, b1, w2q, s2, b2)
  else:
    out = mixer_math.mlp_math(rows, g2, w1, b1, w2, b2, matmul)
  return h, x1, out.reshape(b, t, c)


# Share of a row's int8 hidden values that `q8_error_limit` lets the kernel
# and the plain version hold one step apart.
Q8_FLIP_SHARE = 0.25


def q8_error_limit(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None, qweights=None,
):
  """Per-element limit [B, T, C] float32 on |kernel - plain| for the block
  with the w8a8 channel MLP, and the plain version's int8 operand and
  hidden [B * valid_len, C] / [B * valid_len, H] to count flips against.

  Integer arithmetic is exact on both sides, so the two differ only where a
  value was quantized from inputs that differ: the float32 LayerNorms sum in
  another order (1e-7 relative), and in bfloat16 the kernel keeps LN1's
  output in float32 where the plain version rounds it, so h and x1 can land
  a bfloat16 step apart. A value next to a rounding boundary then takes the
  neighbouring int8 step. One step of one hidden value moves y[row, col] by
  hs[row] * |w2q[k, col]| * s2[col]; if a share Q8_FLIP_SHARE of a row's
  hidden values flip with independent signs, y moves by about
  sqrt(share) * hs[row] * ||w2q[:, col]|| * s2[col]. The limit is four such
  deviations, on top of the full-precision block's allowance: in bfloat16
  two steps of each value the two sides round separately (as
  `bf16_error_limit`), in float32 1e-4 absolute and relative. Rows >=
  valid_len get limit 0.
  """
  w1q, s1, w2q, s2 = qweights = _quantized_weights(w1, w2, qweights)
  h, x1, _ = _reference_parts(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2,
                              causal, valid_len, True, qweights)
  b, t, c = x1.shape
  out, xq, hq, hs = mixer_math.mlp_math_q8_parts(
      x1.reshape(b * t, c), g2, w1q, s1, b1, w2q, s2, b2)
  h, x1, out = h.float(), x1.float(), out.float().reshape(b, t, c)
  if x.dtype == torch.bfloat16:
    y_rms = (out - x1).square().mean(-1, keepdim=True).sqrt()
    limit = 2 * 2.0**-7 * (h.abs() + x1.abs() + out.abs() + y_rms)
  else:
    limit = 1e-4 * (1 + out.abs())
  col = torch.linalg.vector_norm(w2q.float(), dim=0) * s2  # [C]
  limit = limit + 4 * Q8_FLIP_SHARE**0.5 * (hs * col).reshape(b, t, c)
  return F.pad(limit, (0, 0, 0, x.shape[1] - t)), xq, hq


def mixer_block_reference(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None, quantized: bool = False, qweights=None,
):
  """Plain version of the whole block. x: [B, T, C].

  With `valid_len`, rows >= valid_len are padding: ignored on input and
  exactly zero on output. With `quantized`, the channel MLP is
  `mixer_math.mlp_math_q8` on x1.
  """
  _, _, y = _reference_parts(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2,
                             causal, valid_len, quantized, qweights)
  return F.pad(y, (0, 0, 0, x.shape[1] - y.shape[1]))


def tf32x3_matmul(terms="tf32x3"):
  """A product a [..., K] . w [K, N] of float32 operands computed from their
  TF32 parts (`tma_gemm.TF32X3_TERMS[terms]`, e.g. "small_big" = A_small .
  B_big) in float64 and rounded to float32 once: the float32 kernel's
  arithmetic with an exact accumulator (`mixer_math.mlp_math`'s `matmul`)."""

  def matmul(a, w):
    return sum(torch.matmul(left, right)
               for left, right in tma_gemm.tf32x3_pairs(a, w, terms)).float()

  return matmul


def mixer_block_tf32x3(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None, terms: str = "tf32x3",
):
  """The plain float32 block with its two products as `tf32x3_matmul(terms)`
  computes them: with "tf32x3", what the float32 kernel computes, up to the
  order of its float32 sums."""
  _, _, y = _reference_parts(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2,
                             causal, valid_len, matmul=tf32x3_matmul(terms))
  return F.pad(y, (0, 0, 0, x.shape[1] - y.shape[1]))


def fp32_controls(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None,
):
  """Faulty float32 blocks that the float32 kernel's limit (1e-4 absolute and
  relative against `mixer_block_reference`) must refuse: `single_tf32`,
  both products in one TF32 product (on a CUDA tensor the plain block with
  `torch.backends.cuda.matmul.allow_tf32` on; on the CPU float64 products of
  the operands rounded to TF32); `no_small_a`, the split without its
  A_small . B_big term (A rounded to TF32)."""
  args = (x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len)
  if x.device.type == "cuda":
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
      single = mixer_block_reference(*args)
    finally:
      torch.backends.cuda.matmul.allow_tf32 = before
  else:
    single = mixer_block_tf32x3(*args, terms="single_tf32")
  return {"single_tf32": single,
          "no_small_a": mixer_block_tf32x3(*args, terms="no_small_a")}


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


def _check_launch(x, g1, wu, bu, wm, bm, g2, b1, b2, hid, valid_len):
  """Raises on what the CUDA kernels do not take; returns (b, t, t_real, c,
  mult, k)."""
  if x.dtype not in _DTYPES:
    raise TypeError(f"mixer_block: x must be float32 or bfloat16, got {x.dtype}")
  b, t, c = x.shape
  k = wu.shape[0]
  mult = wu.shape[-1] // c
  if k != 3:
    raise ValueError(f"The CUDA mixer-block kernel is built for k=3, got {k}.")
  expected = {
      "g1": (c,), "wu": (k, 1, mult * c), "bu": (mult * c,),
      "wm": (k, 1, mult * c), "bm": (mult * c,), "g2": (c,),
      "b1": (hid,), "b2": (c,),
  }
  params = dict(g1=g1, wu=wu, bu=bu, wm=wm, bm=bm, g2=g2, b1=b1, b2=b2)
  for name, shape in expected.items():
    p = params[name]
    if tuple(p.shape) != shape or p.dtype != x.dtype or p.device != x.device:
      raise ValueError(
          f"mixer_block: {name} is {tuple(p.shape)} {p.dtype} on {p.device}, "
          f"expected {shape} {x.dtype} on {x.device}"
      )
  if not all(o.is_contiguous() for o in (x, *params.values())):
    raise ValueError("mixer_block: x and the block parameters must be contiguous")
  t_real = t if valid_len is None else int(valid_len)
  if not 0 <= t_real <= t:
    raise ValueError(f"mixer_block: valid_len {valid_len} outside [0, {t}]")
  return b, t, t_real, c, mult, k


def _launch(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len):
  global LAUNCHES
  hid = w1.shape[1]
  b, t, t_real, c, mult, k = _check_launch(
      x, g1, wu, bu, wm, bm, g2, b1, b2, hid, valid_len)
  plan = launch_plan(b, t, c, hid, x.dtype)
  for name, w, shape in (("w1", w1, (c, hid)), ("w2", w2, (hid, c))):
    if tuple(w.shape) != shape or w.dtype != x.dtype or w.device != x.device:
      raise ValueError(
          f"mixer_block: {name} is {tuple(w.shape)} {w.dtype} on {w.device}, "
          f"expected {shape} {x.dtype} on {x.device}"
      )
  w1_t, w2_t = _linear_layout(w1), _linear_layout(w2)
  if x.dtype == torch.bfloat16 and any(o.data_ptr() % 16 for o in (w1_t, w2_t)):
    raise ValueError("mixer_block: bf16 weights must be 16-byte aligned")

  lib = _build.load("fused_mixer_block", _SIGNATURES)
  x1 = torch.empty_like(x)
  mlp_in = torch.empty_like(x)
  hidden = torch.empty((b * t, hid), dtype=x.dtype, device=x.device)
  # float32: the weights' big and small TF32 parts, [2, H, C] and [2, C, H].
  wsplit = (torch.empty((4 * hid * c,), dtype=x.dtype, device=x.device)
            if x.dtype == torch.float32 else None)
  out = torch.empty_like(x)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  with torch.cuda.device(x.device):
    err = lib.mixer_block_forward(
        *[o.data_ptr() for o in (x, g1, wu, bu, wm, bm, g2, w1_t, b1, w2_t, b2)],
        x1.data_ptr(), mlp_in.data_ptr(), hidden.data_ptr(),
        None if wsplit is None else wsplit.data_ptr(), out.data_ptr(),
        b, t, t_real, c, hid, mult, k, int(bool(causal)),
        plan["gemm_smem_bytes"], _DTYPES[x.dtype], stream,
    )
  _build.check(lib, err, "mixer_block_forward")
  LAUNCHES += 1
  return out


# K4's launch plan, as csrc/fused_mixer_block.cu launches it (kTileT,
# kMlpRows, kMlpTile, kMlpStages, kMlpWgs, kMlpW1K, mlp_smem_bytes): the
# temporal half, one block per row and 16 time steps; the channel MLP, one
# CTA per 64 rows of rows*T, with the int8 operand, two buffers of a
# 128-column chunk of the int8 hidden and, for each of its four warpgroups, a
# ring of 8 KB W1 / W2 tiles in shared memory, and the second product's sums
# for up to 512 output columns in registers. The kernel refuses a plan whose
# shared memory differs from its own count.
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100
THREADS = 256
_TILE_T = 16
_PANEL = 64  # bytes of K per panel row (csrc/q8_tile.cuh)
_SMEM_ALIGN = 1024  # slack to align the panels (csrc/q8_tile.cuh)
_MLP_ROWS, _MLP_TILE, _MLP_STAGES, _MLP_WGS, _MLP_W1K = 64, 128, 4, 4, 256
_MLP_MAX_C = 512  # output columns the MLP holds in registers, 128 a warpgroup
_INT32_MAX = 2**31 - 1


# K3's launch plan, as csrc/fused_mixer_block.cu launches it: the temporal
# half (one block per row and 16 time steps, LN1 of the tile and its halo in
# float32 shared memory), then the two products of the channel MLP over the
# rows*T rows on the TMA + wgmma loop (`tma_gemm.gemm_plan`: GEMM 1 [rows*T,
# H] over K = C, GEMM 2 [rows*T, C] over K = H), in bf16 on 128 x 256 tiles,
# in float32 on 128 x 128 tiles of error-compensated TF32. The kernel
# refuses a plan whose GEMM shared memory differs from its own count.


def launch_plan(b, t, c, hid, dtype=torch.bfloat16):
  """How the full-precision block launches on x [b, t, c] with hidden width
  hid in `dtype`: the temporal half's grid and dynamic shared memory, and
  each product's plan with the GEMMs' dynamic shared memory. Raises for what
  the kernels do not take: C and H must be multiples of 16 bytes of the
  dtype (the TMA rows' strides and the epilogue's 16-byte stores)."""
  if dtype not in _DTYPES:
    raise TypeError(f"mixer_block: x must be float32 or bfloat16, got {dtype}")
  if min(b, t, c, hid) <= 0:
    raise ValueError(f"mixer_block: empty shape {(b, t, c)}, H={hid}")
  unit = 16 // _ELEMENT_BYTES[dtype]
  if c % unit or hid % unit:
    raise ValueError(f"mixer_block: {dtype} kernel needs C and H multiples of "
                     f"{unit}")
  rows = b * t
  if b * -(-t // _TILE_T) > _INT32_MAX:
    raise ValueError(f"mixer_block: {rows} rows overflow the kernels' grid")
  temporal = dict(grid=b * -(-t // _TILE_T),
                  smem_bytes=4 * (_TILE_T + 2 * (3 - 1)) * c, threads=THREADS)
  if temporal["smem_bytes"] > SMEM_LIMIT:
    raise ValueError(f"mixer_block: C={c} needs more than the {SMEM_LIMIT} "
                     "bytes of shared memory a block may use")
  tile_n = tma_gemm.TILE_N if dtype == torch.bfloat16 else tma_gemm.TILE_N_TF32
  elt = _ELEMENT_BYTES[dtype]
  up = tma_gemm.gemm_plan(rows, hid, elt * c, tile_n=tile_n)
  down = tma_gemm.gemm_plan(rows, c, elt * hid, tile_n=tile_n)
  return dict(rows=rows, temporal=temporal, gemm_up=up, gemm_down=down,
              gemm_smem_bytes=tma_gemm.SMEM_BYTES)


def _linear_layout(w):
  """Linear's [out, in] layout of a [in, out] weight: for the transposed view
  of a Linear weight, a view of its own storage; otherwise a copy."""
  return w.t().contiguous()


def q8_launch_plan(b, t, c, hid, dtype=torch.bfloat16):
  """How the w8a8 block launches on x [b, t, c] with hidden width hid in
  `dtype`: grid and dynamic shared memory of the temporal half, and rows per
  block, shared-memory bytes, grid and ring stages of the channel MLP.
  Raises for what the kernels do not take."""
  if dtype not in _DTYPES:
    raise TypeError(f"mixer_block: x must be float32 or bfloat16, got {dtype}")
  if min(b, t, c, hid) <= 0:
    raise ValueError(f"mixer_block: empty shape {(b, t, c)}, H={hid}")
  if c % 16 or hid % 16:
    raise ValueError("mixer_block: int8 kernel needs C and H multiples of 16")
  if c > _MLP_MAX_C:
    raise ValueError(
        f"mixer_block: the int8 MLP holds at most {_MLP_MAX_C} output columns "
        f"in registers, got C={c}")
  rows = b * t
  if rows + _MLP_ROWS > _INT32_MAX or b * -(-t // _TILE_T) > _INT32_MAX:
    raise ValueError(f"mixer_block: {rows} rows overflow the kernels' grid")
  temporal_smem = 4 * (_TILE_T + 2 * (3 - 1)) * c
  ktiles = -(-c // _MLP_W1K)
  mlp_smem = (_SMEM_ALIGN + ktiles * _MLP_W1K * _MLP_ROWS
              + 2 * 2 * _MLP_ROWS * _PANEL
              + _MLP_WGS * _MLP_STAGES * _MLP_ROWS * _MLP_TILE
              + _MLP_ROWS * 4 * (_MLP_WGS + 2))
  if max(temporal_smem, mlp_smem) > SMEM_LIMIT:
    raise ValueError(f"mixer_block: C={c} needs more than the {SMEM_LIMIT} "
                     "bytes of shared memory a block may use")
  return dict(
      rows=rows,
      temporal=dict(grid=b * -(-t // _TILE_T), smem_bytes=temporal_smem,
                    threads=THREADS),
      mlp=dict(rows_per_block=_MLP_ROWS, smem_bytes=mlp_smem,
               grid=-(-rows // _MLP_ROWS), stages=_MLP_STAGES,
               threads=128 * _MLP_WGS),
  )


def _launch_q8(x, g1, wu, bu, wm, bm, g2, b1, b2, qweights, causal, valid_len,
               scratch=None):
  """The block with the w8a8 channel MLP on the card. If `scratch` is a dict,
  the kernels' intermediate tensors are left in it (x1, the int8 operand with
  its row scales, and the float32 hidden that the MLP quantizes with its int8
  form and row scales), for checks; without it no hidden exists outside the
  kernel."""
  global LAUNCHES_Q8
  w1q, s1, w2q, s2 = qweights
  hid = w1q.shape[1]
  b, t, t_real, c, mult, k = _check_launch(
      x, g1, wu, bu, wm, bm, g2, b1, b2, hid, valid_len)
  plan = q8_launch_plan(b, t, c, hid, x.dtype)
  expected = {
      "w1q": (w1q, (c, hid), torch.int8), "s1": (s1, (hid,), torch.float32),
      "w2q": (w2q, (hid, c), torch.int8), "s2": (s2, (c,), torch.float32),
  }
  for name, (p, shape, dtype) in expected.items():
    if tuple(p.shape) != shape or p.dtype != dtype or p.device != x.device:
      raise ValueError(
          f"mixer_block: {name} is {tuple(p.shape)} {p.dtype} on {p.device}, "
          f"expected {shape} {dtype} on {x.device}"
      )
  # Linear layout [out, in]; no copy when the caller kept that storage.
  w1q_t = w1q.t().contiguous()
  w2q_t = w2q.t().contiguous()
  s1, s2 = s1.contiguous(), s2.contiguous()
  if any(o.data_ptr() % 16 for o in (w1q_t, w2q_t)):
    raise ValueError("mixer_block: int8 weights must be 16-byte aligned")

  lib = _build.load("fused_mixer_block", _SIGNATURES)
  dev = x.device
  rows = plan["rows"]
  # Scratch comes from PyTorch's caching allocator: a stack of blocks takes
  # back, at each call, what the previous block's call released.
  x1 = torch.empty_like(x)
  xq = torch.empty((rows, c), dtype=torch.int8, device=dev)
  xs = torch.empty((rows,), dtype=torch.float32, device=dev)
  hidden = hq = hs = None
  if scratch is not None:
    hidden = torch.empty((rows, hid), dtype=torch.float32, device=dev)
    hq = torch.empty((rows, hid), dtype=torch.int8, device=dev)
    hs = torch.empty((rows,), dtype=torch.float32, device=dev)
  out = torch.empty_like(x)
  stream = torch.cuda.current_stream(dev).cuda_stream
  operands = (x, g1, wu, bu, wm, bm, g2, w1q_t, s1, b1, w2q_t, s2, b2,
              x1, xq, xs, hidden, hq, hs, out)
  with torch.cuda.device(dev):
    err = lib.mixer_block_q8_forward(
        *[None if o is None else o.data_ptr() for o in operands],
        b, t, t_real, c, hid, mult, k, int(bool(causal)),
        plan["mlp"]["smem_bytes"], _DTYPES[x.dtype], stream,
    )
  _build.check(lib, err, "mixer_block_q8_forward")
  LAUNCHES_Q8 += 1
  if scratch is not None:
    scratch.update(x1=x1, xq=xq, xs=xs, hidden=hidden, hq=hq, hs=hs)
  return out


def mixer_block(
    x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal: bool = False,
    valid_len: Optional[int] = None, quantized: bool = False, qweights=None,
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
    quantized: run the channel MLP in w8a8 int8 (the temporal half and the
      LayerNorms stay in full precision).
    qweights: with `quantized`, the weights already quantized per output
      column, (w1q int8 [C, H], s1 float32 [H], w2q int8 [H, C], s2 float32
      [C]) from `mixer_math.quantize_weight_cols`; w1 and w2 are then not
      read and may be None. Without it they are quantized in this call.

  Returns:
    [B, T, C], same dtype as x.

  Differentiable in every tensor argument on every device: the backward is
  the VJP of the full-precision `mixer_block_reference` recomputed from the
  inputs (JAX's `_bwd`), straight-through for `quantized` (`ops._vjp`); a
  quantized block needs w1 and w2 then.
  """
  if x.device.type not in ("cpu", "cuda"):
    raise ValueError(f"mixer_block: unsupported device {x.device}")

  def forward(*args):
    return _forward(*args, causal, valid_len, quantized, qweights)

  def plain(*args):
    if args[7] is None or args[9] is None:
      raise ValueError("mixer_block: its gradient needs w1 and w2")
    return mixer_block_reference(*args, causal, valid_len)

  return _vjp.apply(forward, plain, x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2)


def _forward(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len,
             quantized, qweights):
  """`mixer_block` without its gradient: the kernels on CUDA tensors, the
  plain version on CPU tensors."""
  if x.device.type == "cpu":
    return mixer_block_reference(
        x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal, valid_len,
        quantized, qweights,
    )
  if x.device.type == "cuda":
    if quantized:
      return _launch_q8(x, g1, wu, bu, wm, bm, g2, b1, b2,
                        _quantized_weights(w1, w2, qweights), causal,
                        valid_len)
    return _launch(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, causal,
                   valid_len)
  raise ValueError(f"mixer_block: unsupported device {x.device}")
