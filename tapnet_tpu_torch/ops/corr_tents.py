"""Local correlation + bilinear-tent patches (port of tapnet_tpu/ops/corr_tents.py).

`corr_tent_patches` keeps the JAX public layout: grid [BT, H, W, C] and
query [BT, N, C] in the compute dtype, centres cy/cx [BT, N] float32 in grid
index space (raster - 0.5), output [BT, p, p, N] float32.

  * CPU tensors run `corr_tent_patches_reference`, the port of the JAX
    `_math_reference` (correlation einsum rounded to the compute dtype, tent
    contractions with float32 accumulation).
  * CUDA tensors launch the hand-written kernel `csrc/corr_tents.cu`, which
    computes only the (p+1) x (p+1) correlation window each patch needs
    (its loop and queries per block: `float_launch_plan`).
  * Anything else raises. There is no size gate and no fallback.

The int8 modes (`quantized=True | "per_frame"`, and for grids quantized once
per video `corr_tent_patches_prequantized` after `quantize_per_frame` and
`corr_tent_patches_prequantized_per_position` after `quantize_per_position`)
multiply an int8 grid by int8 queries with int32 accumulation, round the
correlation to bfloat16 (after the per-position grid scale, where there is
one), run the y-tents in bfloat16 whatever the model's dtype, and apply the
per-query and per-frame scales to the float32 output. On CUDA tensors that
is one launch of the kernel `corr_tents_q8_forward` of the same source,
which takes the query in the compute dtype and quantizes it per descriptor
itself, bit-equal to `_quantize_lastdim` (its loop and queries per block:
`q8_launch_plan`); CPU tensors run the plain versions
`corr_tent_patches_*_reference`. The per-position grid quantizer
(`quantize_per_position`) is the kernel `quantize_rows` of the same source
on CUDA tensors, bit-equal to its plain version `_quantize_lastdim`, which
CPU tensors run; the per-frame grid quantizer `quantize_per_frame` is plain
PyTorch on every device (one reduction and one elementwise pass, once per
video).
"""

from __future__ import annotations

import ctypes

import torch

from tapnet_tpu_torch.ops import _build, _vjp

# Number of CUDA kernel launches made through `corr_tent_patches`: the float
# kernel, the int8 kernel with a scale per frame (also reached through
# `corr_tent_patches_prequantized`), the int8 kernel with a scale per grid
# position (also reached through `corr_tent_patches_prequantized_per_position`),
# and the per-row quantizer of the per-position grids (`quantize_rows`).
LAUNCHES = 0
LAUNCHES_Q8_FRAME = 0
LAUNCHES_Q8_POSITION = 0
LAUNCHES_QUANTIZE = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "corr_tents_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "corr_tents_q8_forward": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "quantize_rows": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p],
}


def _tent_weights(coords: torch.Tensor, size: int, p: int) -> torch.Tensor:
  """[..., p, size] separable tents relu(1 - |c + d - i|)."""
  offsets = (
      torch.arange(p, dtype=coords.dtype, device=coords.device) - (p - 1) / 2
  )
  cells = torch.arange(size, dtype=coords.dtype, device=coords.device)
  centers = coords[..., None] + offsets
  return torch.relu(1.0 - (centers[..., None] - cells).abs())


def corr_tent_patches_reference(
    grid: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Plain version: [BT, H, W, C] x [BT, N, C] -> [BT, p, p, N] float32.

  The correlation is accumulated in float32 and rounded to the compute
  dtype; the y-tent stage is rounded to the compute dtype again before the
  x-tent stage, as in the JAX reference.
  """
  dtype = grid.dtype
  corrs = torch.einsum("bhwc,bnc->bnhw", grid.float(), query.float()).to(dtype)
  h, w = grid.shape[1:3]
  wy = _tent_weights(cy.float(), h, p).to(dtype)  # [BT, N, p, H]
  wx = _tent_weights(cx.float(), w, p).to(dtype)  # [BT, N, p, W]
  pat = torch.einsum("bnph,bnhw->bnpw", wy.float(), corrs.float()).to(dtype)
  pat = torch.einsum("bnqw,bnpw->bnpq", wx.float(), pat.float())
  return pat.permute(0, 2, 3, 1)


def _quantize_lastdim(v: torch.Tensor, eps: float = 1e-8):
  """Symmetric per-row int8 quantization over the last axis.

  Returns (int8 values, float32 scale without the last axis). Divides by the
  scale and rounds half to even.
  """
  vf = v.float()
  scale = torch.clamp(vf.abs().amax(-1), min=eps) * (1.0 / 127.0)
  q = torch.clamp(torch.round(vf / scale[..., None]), -127.0, 127.0)
  return q.to(torch.int8), scale


def _launch_quantize(v: torch.Tensor):
  """`quantize_rows` of csrc/corr_tents.cu on a CUDA tensor."""
  global LAUNCHES_QUANTIZE
  if v.dtype not in _DTYPES:
    raise TypeError(f"quantize_rows: float32 or bfloat16, got {v.dtype}")
  if v.ndim == 0 or v.numel() == 0:
    raise ValueError(f"quantize_rows: empty shape {tuple(v.shape)}")
  v = v.contiguous()
  c = v.shape[-1]
  q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
  scale = torch.empty(v.shape[:-1], dtype=torch.float32, device=v.device)
  lib = _build.load("corr_tents", _SIGNATURES)
  stream = torch.cuda.current_stream(v.device).cuda_stream
  with torch.cuda.device(v.device):
    err = lib.quantize_rows(v.data_ptr(), q.data_ptr(), scale.data_ptr(),
                            v.numel() // c, c, _DTYPES[v.dtype], stream)
  _build.check(lib, err, "quantize_rows")
  LAUNCHES_QUANTIZE += 1
  return q, scale


def quantize_per_position(grid: torch.Tensor):
  """Pre-quantizes feature grids for the per-position int8 correlation mode.

  [BT, H, W, C] -> (int8 grid, float32 scale [BT, H, W] per position), what
  `corr_tent_patches(..., quantized=True)` computes inline: `_quantize_lastdim`
  on CPU tensors, the kernel `quantize_rows` (bit-equal to it, any leading
  shape) on CUDA tensors; anything else raises. Call it once per video,
  outside the chunk and iteration loops: a position's scale does not depend
  on the query. The result is what
  `corr_tent_patches_prequantized_per_position` takes."""
  if grid.device.type == "cpu":
    return _quantize_lastdim(grid)
  if grid.device.type == "cuda":
    return _launch_quantize(grid)
  raise ValueError(f"quantize_per_position: unsupported device {grid.device}")


def quantize_per_frame(grid: torch.Tensor):
  """Pre-quantizes feature grids for the per-frame int8 correlation mode.

  [..., H, W, C] -> (int8 grid, float32 scalar scale per leading index).
  Call it once per video, outside the chunk and iteration loops: the result
  is what `corr_tent_patches_prequantized` takes.
  """
  gf = grid.float()
  amax = torch.clamp(gf.abs().amax((-3, -2, -1), keepdim=True), min=1e-8)
  # torch.div rounds 127 / amax once, as JAX does: `127.0 / amax` in PyTorch
  # is reciprocal(amax) * 127, two roundings, which can move a value that
  # sits on a rounding midpoint (bf16 x = amax / 2) by one int8 step.
  q = torch.clamp(torch.round(gf * torch.div(127.0, amax)), -127.0, 127.0)
  return q.to(torch.int8), (amax * (1.0 / 127.0)).reshape(grid.shape[:-3])


def _int8_corr(grid_q8: torch.Tensor, query_q8: torch.Tensor) -> torch.Tensor:
  """int8 [BT, H, W, C] x int8 [BT, N, C] -> int32 [BT, N, H, W], exact: an
  int32 einsum on the CPU; on the card, where PyTorch has no integer matmul,
  a float64 one, which holds every partial sum (at most C * 127^2)."""
  wide = torch.int32 if grid_q8.device.type == "cpu" else torch.float64
  corr = torch.einsum("bhwc,bnc->bnhw", grid_q8.to(wide), query_q8.to(wide))
  return corr.to(torch.int32)


def _bf16_tents(corrs, scale, cy, cx, p):
  """bfloat16 correlation [BT, N, H, W] -> [BT, p, p, N] float32 patches:
  bfloat16 tent weights, the y-stage summed in float32 and rounded to
  bfloat16, the x-stage summed in float32, then the per-(frame, query)
  `scale` [BT, N] on the output."""
  h, w = corrs.shape[2:]
  wy = _tent_weights(cy.float(), h, p).to(torch.bfloat16)
  wx = _tent_weights(cx.float(), w, p).to(torch.bfloat16)
  pat = torch.einsum("bnph,bnhw->bnpw", wy.float(), corrs.float())
  pat = pat.to(torch.bfloat16)
  pat = torch.einsum("bnqw,bnpw->bnpq", wx.float(), pat.float())
  pat = pat * scale[:, :, None, None]
  return pat.permute(0, 2, 3, 1)


def corr_tent_patches_prequantized_reference(
    grid_q8: torch.Tensor,
    frame_scale: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Plain version of the pre-quantized per-frame path: int32 correlation
  rounded straight to bfloat16, bfloat16 tents, every scale on the output."""
  qq, qs = _quantize_lastdim(query)
  corrs = _int8_corr(grid_q8, qq).to(torch.bfloat16)
  return _bf16_tents(corrs, qs * frame_scale[:, None], cy, cx, p)


def corr_tent_patches_prequantized_per_position_reference(
    grid_q8: torch.Tensor,
    pos_scale: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Plain version of the pre-quantized per-position path: the query
  quantized per descriptor, the grid scales [BT, H, W] applied to the int32
  correlation in float32 before it is rounded to bfloat16, the query scales
  on the output."""
  qq, qs = _quantize_lastdim(query)  # [BT, N]
  corrs = (_int8_corr(grid_q8, qq).float() * pos_scale[:, None]).to(
      torch.bfloat16)
  return _bf16_tents(corrs, qs, cy, cx, p)


def corr_tent_patches_quantized_reference(
    grid: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
    per_frame: bool = False,
) -> torch.Tensor:
  """Plain version of the inline int8 modes: the grid quantized per position
  (or per frame, with one scale), then as
  `corr_tent_patches_prequantized_per_position_reference`."""
  if per_frame:
    gq, frame_scale = quantize_per_frame(grid)
    gs = frame_scale[:, None, None].expand(grid.shape[:3])
  else:
    gq, gs = _quantize_lastdim(grid)  # [BT, H, W]
  return corr_tent_patches_prequantized_per_position_reference(
      gq, gs, query, cy, cx, p)


def _check_launch(grid, query, cy, cx, p, extra=()):
  """Raises on what the CUDA kernels do not take; returns (bt, h, w, c, n)."""
  if p != 7:
    raise ValueError(f"The CUDA corr-tents kernel is built for p=7, got {p}.")
  if cy.dtype != torch.float32 or cx.dtype != torch.float32:
    raise TypeError("cy/cx must be float32")
  bt, h, w, c = grid.shape
  n = query.shape[1]
  if query.shape != (bt, n, c) or cy.shape != (bt, n) or cx.shape != (bt, n):
    raise ValueError(
        f"shapes grid {tuple(grid.shape)}, query {tuple(query.shape)}, "
        f"cy {tuple(cy.shape)}, cx {tuple(cx.shape)}"
    )
  tensors = (grid, query, cy, cx) + tuple(extra)
  if any(t.device != grid.device for t in tensors):
    raise ValueError("corr_tent_patches inputs must share one CUDA device")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("corr_tent_patches inputs must be contiguous")
  return bt, h, w, c, n


# The launch plans of K1 and of K2/K2b (the int8 kernel), as
# csrc/corr_tents.cu launches them: blocks of 8 warps, a
# query's warps splitting its 8 window rows, a frame's blocks neighbours in
# launch order. A block takes 8 queries of a frame (a warp each), or 4, 2, 1
# where 8 would leave fewer than _MIN_BLOCKS blocks (an online step, 1 frame
# x 64 queries: 64 blocks of one query instead of 8 of eight) or where the
# frames that the resident blocks cover would hold more than _FRAME_BYTES of
# grid (fewer queries a block spread a frame over more blocks, so fewer
# frames are in flight and their window rows stay in L2: at the served
# 60x60x256 grid in float32, 8 queries a block took 0.53 ms and 2 took 0.36
# on the H100).
_WARPS = 8
_MIN_BLOCKS = 4 * 132  # four blocks per SM of the H100
_RESIDENT_BLOCKS = 3 * 132  # blocks at work at one time, about
_FRAME_BYTES = 32 * 2**20  # of the H100's 50 MB of L2
_MAX_LANE_PIECES = 4  # kMaxLanePieces: 16-byte pieces of a position a lane reads


def float_rows_ok(c: int, element_bytes: int, aligned: bool) -> bool:
  """Whether K1 takes its row-wise loop (16-byte loads) for width c of a
  dtype of `element_bytes` bytes, the csrc's float_rows_ok: C * size a
  power-of-two number of 16-byte pieces from 4 to 32 * _MAX_LANE_PIECES,
  and both bases 16-byte aligned (`aligned`). Otherwise its scalar loop."""
  nbytes = c * element_bytes
  pieces = nbytes // 16
  return (aligned and nbytes % 16 == 0 and 4 <= pieces <= 32 * _MAX_LANE_PIECES
          and pieces & (pieces - 1) == 0)


def float_launch_plan(bt: int, h: int, w: int, c: int, n: int,
                      dtype=torch.bfloat16, aligned: bool = True) -> dict:
  """How K1 launches on a grid [bt, h, w, c] with n queries in `dtype`:
  its loop ("rows" or "scalar"), queries per block, warps per query, grid
  (blocks of queries, bt: a frame's blocks neighbours in launch order) and
  dynamic shared memory (the scalar loop keeps the block's queries in
  float32)."""
  if dtype not in _DTYPES:
    raise TypeError(f"corr_tents: float32 or bfloat16, got {dtype}")
  if min(bt, h, w, c, n) <= 0:
    raise ValueError(f"corr_tents: empty shape {(bt, h, w, c)}, n={n}")
  if bt > 65535:
    raise ValueError(f"corr_tents: {bt} frames overflow the kernel's grid")
  elt = torch.empty((), dtype=dtype).element_size()
  rows = float_rows_ok(c, elt, aligned)
  qpb = _queries_per_block(bt, n, h * w * c * elt)
  return dict(loop="rows" if rows else "scalar", queries_per_block=qpb,
              warps_per_query=_WARPS // qpb, grid=(-(-n // qpb), bt),
              smem_bytes=0 if rows else 4 * qpb * c)


def _queries_per_block(bt: int, n: int, frame_bytes: int) -> int:
  """Queries a block of K1, K2 and K2b takes: 8, or the largest of 4, 2, 1
  that gives the card _MIN_BLOCKS blocks and keeps the grid of the frames
  that the resident blocks cover within _FRAME_BYTES."""
  in_flight = lambda q: min(bt, _RESIDENT_BLOCKS / -(-n // q)) * frame_bytes
  qpb = _WARPS
  while qpb > 1 and (bt * -(-n // qpb) < _MIN_BLOCKS
                     or in_flight(qpb) > _FRAME_BYTES):
    qpb //= 2
  return qpb


# Widths of the int8 kernel's row-wise loop (kQ8MinRowWidth, kQ8MaxRowWidth):
# C = 16 * 2^k, C / 16 lanes a position.
_Q8_ROW_WIDTHS = (64, 512)


def q8_rows_ok(c: int, aligned: bool) -> bool:
  """Whether K2 and K2b take their row-wise loop (16-byte loads of the int8
  grid) for width c, the csrc's q8_rows_ok: C = 16 * 2^k within
  _Q8_ROW_WIDTHS and both bases 16-byte aligned (`aligned`). Otherwise their
  word-wise loop."""
  lo, hi = _Q8_ROW_WIDTHS
  return (aligned and c % 16 == 0 and lo <= c <= hi
          and (c // 16) & (c // 16 - 1) == 0)


def q8_launch_plan(bt: int, h: int, w: int, c: int, n: int,
                   aligned: bool = True) -> dict:
  """How K2 and K2b launch on an int8 grid [bt, h, w, c] with n queries: as
  `float_launch_plan` at one byte a value, with the loop "rows" or "words"
  and dynamic shared memory for the word-wise loop's quantized queries (a
  warp's int8 copy of its query)."""
  if min(bt, h, w, c, n) <= 0:
    raise ValueError(f"int8 corr-tents: empty shape {(bt, h, w, c)}, n={n}")
  if bt > 65535:
    raise ValueError(f"int8 corr-tents: {bt} frames overflow the kernel's grid")
  if c % 4:
    raise ValueError(
        f"int8 corr-tents kernel needs C a multiple of 4, got C={c}")
  rows = q8_rows_ok(c, aligned)
  qpb = _queries_per_block(bt, n, h * w * c)
  return dict(loop="rows" if rows else "words", queries_per_block=qpb,
              warps_per_query=_WARPS // qpb, grid=(-(-n // qpb), bt),
              smem_bytes=0 if rows else _WARPS * c)


def _launch(grid, query, cy, cx, p):
  global LAUNCHES
  if grid.dtype not in _DTYPES or query.dtype != grid.dtype:
    raise TypeError(
        f"grid/query must share float32 or bfloat16, got {grid.dtype}, "
        f"{query.dtype}"
    )
  bt, h, w, c, n = _check_launch(grid, query, cy, cx, p)
  plan = float_launch_plan(
      bt, h, w, c, n, grid.dtype,
      aligned=grid.data_ptr() % 16 == 0 and query.data_ptr() % 16 == 0)
  lib = _build.load("corr_tents", _SIGNATURES)
  out = torch.empty((bt, p, p, n), dtype=torch.float32, device=grid.device)
  stream = torch.cuda.current_stream(grid.device).cuda_stream
  with torch.cuda.device(grid.device):
    err = lib.corr_tents_forward(
        grid.data_ptr(), query.data_ptr(), cy.data_ptr(), cx.data_ptr(),
        out.data_ptr(), bt, h, w, c, n, p, plan["queries_per_block"],
        int(plan["loop"] == "rows"), _DTYPES[grid.dtype], stream,
    )
  _build.check(lib, err, "corr_tents_forward")
  LAUNCHES += 1
  return out


def _launch_q8(grid_q8, query, frame_scale, pos_scale, cy, cx, p):
  """Launches the int8 kernel on an int8 grid and a query in the compute
  dtype, which the kernel quantizes. Exactly one of frame_scale [BT] (K2:
  the output times qs * fs) and pos_scale [BT, H, W] (K2b: the int32
  correlation times it in float32 before the rounding to bfloat16, the
  output times qs)."""
  global LAUNCHES_Q8_FRAME, LAUNCHES_Q8_POSITION
  if grid_q8.dtype != torch.int8 or query.dtype not in _DTYPES:
    raise TypeError(
        "int8 corr-tents needs an int8 grid and a float32 or bfloat16 "
        f"query, got {grid_q8.dtype}, {query.dtype}"
    )
  scale = frame_scale if pos_scale is None else pos_scale
  if scale.dtype != torch.float32:
    raise TypeError("int8 corr-tents scales must be float32")
  bt, h, w, c, n = _check_launch(grid_q8, query, cy, cx, p, (scale,))
  if scale.shape != ((bt,) if pos_scale is None else (bt, h, w)):
    raise ValueError("int8 corr-tents: scale shapes do not match grid/query")
  if grid_q8.data_ptr() % 4:
    raise ValueError("int8 corr-tents kernel needs a 4-byte aligned grid")
  plan = q8_launch_plan(  # raises for C % 4 != 0
      bt, h, w, c, n,
      aligned=grid_q8.data_ptr() % 16 == 0 and query.data_ptr() % 16 == 0)
  lib = _build.load("corr_tents", _SIGNATURES)
  out = torch.empty((bt, p, p, n), dtype=torch.float32, device=grid_q8.device)
  stream = torch.cuda.current_stream(grid_q8.device).cuda_stream
  with torch.cuda.device(grid_q8.device):
    err = lib.corr_tents_q8_forward(
        grid_q8.data_ptr(), query.data_ptr(),
        0 if pos_scale is None else pos_scale.data_ptr(),
        0 if frame_scale is None else frame_scale.data_ptr(),
        cy.data_ptr(), cx.data_ptr(), out.data_ptr(),
        bt, h, w, c, n, p, plan["queries_per_block"],
        int(plan["loop"] == "rows"), _DTYPES[query.dtype], stream,
    )
  _build.check(lib, err, "corr_tents_q8_forward")
  if pos_scale is None:
    LAUNCHES_Q8_FRAME += 1
  else:
    LAUNCHES_Q8_POSITION += 1
  return out


def corr_tent_patches(
    grid: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
    quantized: "bool | str" = False,
) -> torch.Tensor:
  """Correlation patches around track positions.

  Args:
    grid: [BT, H, W, C] feature grids (one per (batch, frame)).
    query: [BT, N, C] per-frame query descriptors, grid's dtype.
    cy / cx: [BT, N] float32 patch centres in grid index space.
    p: patch size (odd; the CUDA kernels are built for 7).
    quantized: int8 correlation with int32 accumulation. "per_frame": one
      grid scale per frame and one per query descriptor, all applied to the
      output (quantizes the grid in this call; a caller that reuses grids
      quantizes them once with `quantize_per_frame` and calls
      `corr_tent_patches_prequantized`). True: one grid scale per position,
      applied to the correlation before the tents mix positions (likewise
      `quantize_per_position` and
      `corr_tent_patches_prequantized_per_position`). The tents run in
      bfloat16 in both.

  Returns:
    [BT, p, p, N] float32 tent-interpolated correlation patches.

  Differentiable in grid, query, cy and cx on every device: the backward is
  the VJP of `corr_tent_patches_reference` recomputed from the inputs (JAX's
  `_bwd`), straight-through for the int8 modes (`ops._vjp`).
  """
  if quantized not in (False, True, "per_frame"):
    raise ValueError(f"corr_tent_patches: quantized={quantized!r}")
  if grid.device.type not in ("cpu", "cuda"):
    raise ValueError(f"corr_tent_patches: unsupported device {grid.device}")
  return _vjp.apply(
      lambda g, q, y, x: _forward(g, q, y, x, p, quantized),
      lambda g, q, y, x: corr_tent_patches_reference(g, q, y, x, p),
      grid, query, cy, cx)


def _forward(grid, query, cy, cx, p, quantized):
  """`corr_tent_patches` without its gradient: the kernel on CUDA tensors,
  the plain version on CPU tensors."""
  device = grid.device.type
  if not quantized:
    if device == "cpu":
      return corr_tent_patches_reference(grid, query, cy, cx, p)
    return _launch(grid, query, cy, cx, p)
  if quantized == "per_frame":
    return corr_tent_patches_prequantized(
        *quantize_per_frame(grid), query, cy, cx, p
    )
  if device == "cpu":
    return corr_tent_patches_quantized_reference(grid, query, cy, cx, p)
  return corr_tent_patches_prequantized_per_position(
      *quantize_per_position(grid), query, cy, cx, p)


def _no_gradient(name, *inputs):
  if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
    raise ValueError(
        f"{name} has no gradient (inference only); differentiate "
        "corr_tent_patches(..., quantized=...) instead")


def corr_tent_patches_prequantized(
    grid_q8: torch.Tensor,
    frame_scale: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Per-frame int8 correlation patches from a pre-quantized grid.

  Args:
    grid_q8: [BT, H, W, C] int8 (from `quantize_per_frame`).
    frame_scale: [BT] float32 per-frame scales.
    query / cy / cx / p: as `corr_tent_patches`; the query is quantized per
      descriptor in this call (on CUDA tensors inside the kernel).

  Inference only, as in JAX: it carries no gradient and raises if asked for
  one (training quantizes inside `corr_tent_patches`).
  """
  _no_gradient("corr_tent_patches_prequantized", query, cy, cx)
  device = grid_q8.device.type
  if device == "cpu":
    return corr_tent_patches_prequantized_reference(
        grid_q8, frame_scale, query, cy, cx, p
    )
  if device == "cuda":
    return _launch_q8(grid_q8, query, frame_scale, None, cy, cx, p)
  raise ValueError(
      f"corr_tent_patches_prequantized: unsupported device {grid_q8.device}"
  )


def corr_tent_patches_prequantized_per_position(
    grid_q8: torch.Tensor,
    pos_scale: torch.Tensor,
    query: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    p: int = 7,
) -> torch.Tensor:
  """Per-position int8 correlation patches from a pre-quantized grid: what
  `corr_tent_patches(..., quantized=True)` computes, bit for bit.

  Args:
    grid_q8: [BT, H, W, C] int8 (from `quantize_per_position`).
    pos_scale: [BT, H, W] float32 per-position scales.
    query / cy / cx / p: as `corr_tent_patches`; the query is quantized per
      descriptor in this call (on CUDA tensors inside the kernel).

  Inference only, like `corr_tent_patches_prequantized`.
  """
  _no_gradient("corr_tent_patches_prequantized_per_position", query, cy, cx)
  device = grid_q8.device.type
  if device == "cpu":
    return corr_tent_patches_prequantized_per_position_reference(
        grid_q8, pos_scale, query, cy, cx, p)
  if device == "cuda":
    return _launch_q8(grid_q8, query, None, pos_scale, cy, cx, p)
  raise ValueError(
      "corr_tent_patches_prequantized_per_position: unsupported device "
      f"{grid_q8.device}")
