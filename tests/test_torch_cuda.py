"""PyTorch port, CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the main-path shapes are held in chip_smoke.py):
the full-precision corr-tents and mixer-block kernels and their int8 forms
(the int8 corr-tents quantizing its queries itself) with the per-row
quantizer of the per-position grids,
the per-frame int8 convolution, the per-pixel and the full-precision
ExtraConvs layers (K6, K6f) and the RG-LRU linear scan (K5) with its
backward (K5b).

Marked `gpu`: skips without a CUDA card. This file imports no JAX, so it also
runs where only the port is installed:

  python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu_torch.models import layers, rglru
from tapnet_tpu_torch.ops import (
    _build, corr_tents, fused_extra_convs, fused_mixer_block, mixer_math, qconv,
    scan,
)

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


# Kernel vs plain on the card, as (rtol, atol). fp32: summation order.
# bf16, for unit-norm grid and query rows (|corr| <= 1): both sides round the
# same correlation to bf16 and may land one step (<= 2^-7) apart; the plain
# version also rounds the y-tent stage and the x-tents to bf16 (<= 2^-8 of
# |corr| each) where the kernel keeps them in fp32. Sum: 2^-6.
CORR_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.0, 2.0**-6)}


# (bt, h, w, C, n): a width of no power of two of 16-byte pieces (the scalar
# loop), ragged grids, every power-of-two width from 16 to 256 at several
# frames (the row-wise loop from 4 to 32 lanes a position, 2 pieces a lane at
# C = 256 in fp32; the scalar loop at C = 16 in bf16), and an online step's
# one frame of 64 queries (a query a block, its 8 warps splitting the window
# rows).
CORR_SHAPES = {
    "tiny": (3, 12, 10, 40, 5), "ragged": (2, 39, 17, 128, 70),
    **{f"frames_c{c}": (3, 21, 17, c, 37) for c in (16, 32, 64, 256)},
    **{f"online_c{c}": (1, 16, 16, c, 64) for c in (16, 32, 64, 128, 256)},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,h,w,c,n", list(CORR_SHAPES.values()),
                         ids=list(CORR_SHAPES))
def test_corr_tents_kernel_matches_plain(cuda, dtype, bt, h, w, c, n):
  rng = np.random.RandomState(0)
  grid = rng.randn(bt, h, w, c).astype(np.float32)
  grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
  query = rng.randn(bt, n, c).astype(np.float32)
  query /= np.linalg.norm(query, axis=-1, keepdims=True)
  cy = (rng.rand(bt, n) * (h + 8) - 4).astype(np.float32)
  cx = (rng.rand(bt, n) * (w + 8) - 4).astype(np.float32)
  tdt = DTYPES[dtype]
  args = [torch.from_numpy(grid).to(cuda, tdt), torch.from_numpy(query).to(cuda, tdt),
          torch.from_numpy(cy).to(cuda), torch.from_numpy(cx).to(cuda)]
  row_bytes = c * args[0].element_size()
  expected = "rows" if row_bytes in (64, 128, 256, 512, 1024) else "scalar"
  assert corr_tents.float_launch_plan(bt, h, w, c, n, tdt)["loop"] == expected
  before = corr_tents.LAUNCHES
  out = corr_tents.corr_tent_patches(*args, 7)
  torch.cuda.synchronize()
  assert corr_tents.LAUNCHES == before + 1
  ref = corr_tents.corr_tent_patches_reference(*args, 7)
  rtol, atol = CORR_TOL[dtype]
  torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


def _unit_rows(rng, *shape):
  v = rng.randn(*shape).astype(np.float32)
  return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_tents_kernel_misaligned_base_takes_the_scalar_loop(cuda, dtype):
  """Grid and query views 4 bytes past a 16-byte boundary: the scalar loop,
  which reads value by value and never past the views' ends (the storage
  after them holds NaN, which a stray read would carry into the patches)."""
  rng = np.random.RandomState(5)
  tdt = DTYPES[dtype]
  bt, h, w, c, n = 2, 13, 11, 128, 19
  off = 4 // torch.empty((), dtype=tdt).element_size()
  grid_store = torch.full((bt * h * w * c + 2 * off,), float("nan"), device=cuda,
                          dtype=tdt)
  query_store = torch.full((bt * n * c + 2 * off,), float("nan"), device=cuda,
                           dtype=tdt)
  grid = grid_store[off:off + bt * h * w * c].view(bt, h, w, c)
  query = query_store[off:off + bt * n * c].view(bt, n, c)
  grid.copy_(torch.from_numpy(_unit_rows(rng, bt, h, w, c)))
  query.copy_(torch.from_numpy(_unit_rows(rng, bt, n, c)))
  cy = torch.from_numpy((rng.rand(bt, n) * (h + 8) - 4).astype(np.float32)).to(cuda)
  cx = torch.from_numpy((rng.rand(bt, n) * (w + 8) - 4).astype(np.float32)).to(cuda)
  assert grid.data_ptr() % 16 and query.data_ptr() % 16
  assert corr_tents.float_launch_plan(bt, h, w, c, n, tdt,
                                      aligned=False)["loop"] == "scalar"
  out = corr_tents.corr_tent_patches(grid, query, cy, cx, 7)
  torch.cuda.synchronize()
  assert bool(torch.isfinite(out).all())
  ref = corr_tents.corr_tent_patches_reference(grid, query, cy, cx, 7)
  rtol, atol = CORR_TOL[dtype]
  torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


# fp32: error-compensated TF32 products (about 2^-21 of a product) and
# float32 sums in another order than cuBLAS fp32 (TF32 off): 1e-4, the limit
# chip_smoke.py holds the served block to, which one TF32 product breaks
# (`fused_mixer_block.fp32_controls`).
# bf16: elementwise, two bf16 steps of each value that the kernel and the
# plain version round separately (`fused_mixer_block.bf16_error_limit`).
MIXER_FP32_TOL = (1e-4, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "b,t,valid_len,c,hid",
    [(3, 13, None, 64, 256), (5, 37, 30, 128, 512),
     (9, 41, 29, 96, 336), (1, 300, 250, 512, 2048)],
    ids=["one_tile", "tiles_valid_len", "ragged_tiles_valid_len",
         "served_width_valid_len"],
)
def test_mixer_block_kernel_matches_plain(cuda, dtype, causal, b, t, valid_len,
                                          c, hid):
  rng = np.random.RandomState(1)
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
  args = [
      f(b, t, c) * 0.5, f(c) * 0.2 + 1, f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1,
      f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1, f(c) * 0.2 + 1,
      f(c, hid) * 0.1, f(hid) * 0.1, f(hid, c) * 0.1, f(c) * 0.1,
  ]
  args = [a.to(cuda, DTYPES[dtype]) for a in args]
  before = fused_mixer_block.LAUNCHES
  out = fused_mixer_block.mixer_block(*args, causal, valid_len)
  torch.cuda.synchronize()
  assert fused_mixer_block.LAUNCHES == before + 1
  ref = fused_mixer_block.mixer_block_reference(*args, causal, valid_len)
  if dtype == "float32":
    rtol, atol = MIXER_FP32_TOL
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
  else:
    limit = fused_mixer_block.bf16_error_limit(*args, causal, valid_len)
    err = (out.float() - ref.float()).abs()
    assert (err <= limit).all(), float((err / limit.clamp_min(1e-30)).max())
  if valid_len is not None:
    assert not out[:, valid_len:].any()


def _mixer_args(cuda, rng, b, t, c, hid):
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
  args = [
      f(b, t, c), f(c) * 0.2 + 1, f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1,
      f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1, f(c) * 0.2 + 1,
      f(c, hid) / c**0.5, f(hid) * 0.1, f(hid, c) / hid**0.5, f(c) * 0.1,
  ]
  return [a.to(cuda) for a in args]


@pytest.mark.parametrize(
    "b,t,valid_len,causal",
    [(128, 250, None, False), (128, 250, None, True), (32, 8, None, True),
     (7, 45, 40, False)],
    ids=["served", "served_causal", "offline_causal", "rows_not_tiles"],
)
def test_mixer_block_fp32_kernel_at_served_widths(cuda, b, t, valid_len,
                                                  causal):
  """The float32 block (error-compensated TF32 products) at C = 512, H =
  2048: the served shape, SAME and causal, the offline causal run's shape,
  and rows * T = 315 (no multiple of the 128-row tile) with t_real < T;
  within MIXER_FP32_TOL, which both `fp32_controls` break."""
  args = _mixer_args(cuda, np.random.RandomState(2), b, t, 512, 2048)
  before = fused_mixer_block.LAUNCHES
  out = fused_mixer_block.mixer_block(*args, causal, valid_len)
  torch.cuda.synchronize()
  assert fused_mixer_block.LAUNCHES == before + 1
  ref = fused_mixer_block.mixer_block_reference(*args, causal, valid_len)
  rtol, atol = MIXER_FP32_TOL
  torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
  if valid_len is not None:
    assert not out[:, valid_len:].any()
  if b * t <= 4096:
    for key, faulty in fused_mixer_block.fp32_controls(
        *args, causal, valid_len).items():
      over = ((faulty - ref).abs() / (atol + rtol * ref.abs())).max()
      assert float(over) > 1.0, key


# ------------------------------------------------------------- int8 kernels

# The int8 corr-tents kernel and its plain version make the same roundings at
# the same points: an exact integer correlation, one rounding to bf16 (after
# the float32 grid scale, where there is one), bf16 tent weights, float32
# sums of two exact products per stage, the y-stage rounded to bf16, one
# float32 multiply by the output scale. The kernel quantizes the query itself
# with the plain quantizer's arithmetic, bit for bit. So the two agree to
# float32 rounding: 1e-6 relative, with an absolute floor of 1e-6 of the
# largest value.
CORR_Q8_RTOL = 1e-6


def _corr_args(cuda, dtype, bt, h, w, c, n):
  rng = np.random.RandomState(0)
  grid = rng.randn(bt, h, w, c).astype(np.float32)
  grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
  # Frames and positions of very different size, so the scales matter.
  grid *= (rng.rand(bt, h, w, 1) * 3 + 0.1).astype(np.float32)
  query = rng.randn(bt, n, c).astype(np.float32)
  query *= (rng.rand(bt, n, 1) * 2 + 0.1).astype(np.float32) / np.sqrt(c)
  cy = (rng.rand(bt, n) * (h + 8) - 4).astype(np.float32)
  cx = (rng.rand(bt, n) * (w + 8) - 4).astype(np.float32)
  tdt = DTYPES[dtype]
  return [torch.from_numpy(grid).to(cuda, tdt),
          torch.from_numpy(query).to(cuda, tdt),
          torch.from_numpy(cy).to(cuda), torch.from_numpy(cx).to(cuda)]


# (bt, h, w, C, n) -> (loop, queries a block). C = 40: word-wise loop at a
# width that is no power of two; 16 and 32: the small configurations' widths,
# word-wise; 64: the narrowest row-wise width (4 lanes a position); 128 and
# 256: the full widths. The first six take a query a block (too few for 528
# blocks); the last four 8, 4, 2 and 1 (q8_launch_plan), with N no multiple
# of the block's queries. Centres lie up to 4 cells off every edge.
CORR_Q8_SHAPES = {
    "tiny": ((3, 12, 10, 40, 5), ("words", 1)),
    "ragged": ((2, 39, 17, 128, 70), ("rows", 1)),
    "wide": ((2, 9, 30, 256, 13), ("rows", 1)),
    "c16": ((2, 11, 9, 16, 9), ("words", 1)),
    "c32": ((2, 8, 13, 32, 11), ("words", 1)),
    "c64": ((2, 10, 12, 64, 10), ("rows", 1)),
    "qpb8": ((17, 9, 11, 128, 253), ("rows", 8)),
    "qpb4": ((9, 10, 12, 256, 251), ("rows", 4)),
    "qpb2": ((8, 12, 9, 128, 250), ("rows", 2)),
    "qpb1_c32": ((1, 14, 13, 32, 61), ("words", 1)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prequantized", "per_frame", "per_position",
                                  "prequantized_per_position"])
@pytest.mark.parametrize(
    "bt,h,w,c,n", [shape for shape, _ in CORR_Q8_SHAPES.values()],
    ids=list(CORR_Q8_SHAPES),
)
def test_corr_tents_q8_kernel_matches_plain(cuda, dtype, mode, bt, h, w, c, n):
  grid, query, cy, cx = _corr_args(cuda, dtype, bt, h, w, c, n)
  plan = corr_tents.q8_launch_plan(bt, h, w, c, n)
  loop, qpb = next(v for s, v in CORR_Q8_SHAPES.values() if s == (bt, h, w, c, n))
  assert (plan["loop"], plan["queries_per_block"]) == (loop, qpb)
  frame = (corr_tents.LAUNCHES_Q8_FRAME, corr_tents.LAUNCHES_Q8_POSITION)
  quantized = corr_tents.LAUNCHES_QUANTIZE
  if mode == "prequantized_per_position":
    gq, gs = corr_tents.quantize_per_position(grid)
    out = corr_tents.corr_tent_patches_prequantized_per_position(
        gq, gs, query, cy, cx, 7)
    ref = corr_tents.corr_tent_patches_prequantized_per_position_reference(
        gq, gs, query, cy, cx, 7)
    # The route the model takes is the inline one, bit for bit.
    inline = corr_tents.corr_tent_patches(grid, query, cy, cx, 7, True)
    torch.testing.assert_close(out, inline, rtol=0, atol=0)
  elif mode == "prequantized":
    gq, gs = corr_tents.quantize_per_frame(grid)
    out = corr_tents.corr_tent_patches_prequantized(gq, gs, query, cy, cx, 7)
    ref = corr_tents.corr_tent_patches_prequantized_reference(
        gq, gs, query, cy, cx, 7)
  elif mode == "per_frame":
    out = corr_tents.corr_tent_patches(grid, query, cy, cx, 7, "per_frame")
    ref = corr_tents.corr_tent_patches_prequantized_reference(
        *corr_tents.quantize_per_frame(grid), query, cy, cx, 7)
  else:
    out = corr_tents.corr_tent_patches(grid, query, cy, cx, 7, True)
    ref = corr_tents.corr_tent_patches_quantized_reference(
        grid, query, cy, cx, 7)
  torch.cuda.synchronize()
  after = (corr_tents.LAUNCHES_Q8_FRAME, corr_tents.LAUNCHES_Q8_POSITION)
  expected = {"per_position": (0, 1), "prequantized_per_position": (0, 2)}.get(
      mode, (1, 0))
  assert (after[0] - frame[0], after[1] - frame[1]) == expected
  # The kernel quantizes the query; quantize_rows runs only on per-position
  # grids (the pre-quantized one, and the inline route's own).
  assert corr_tents.LAUNCHES_QUANTIZE - quantized == {
      "per_position": 1, "prequantized_per_position": 2}.get(mode, 0)
  assert out.shape == (bt, 7, 7, n) and out.dtype == torch.float32
  assert float(ref.abs().max()) > 0.05
  torch.testing.assert_close(
      out, ref, rtol=CORR_Q8_RTOL, atol=CORR_Q8_RTOL * float(ref.abs().max()))
  # The float kernel on the same inputs: the int8 result is that, quantized.
  full = corr_tents.corr_tent_patches(grid, query, cy, cx, 7)
  assert float((out - full).abs().max()) < 0.05 * float(full.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what", ["grid", "query"])
def test_corr_tents_q8_kernel_misaligned_base_takes_the_word_loop(cuda, dtype,
                                                                  what):
  """An int8 grid 4 bytes past a 16-byte boundary, or a query view 4 bytes
  past one, at a row-wise width (C = 128): the word-wise loop, which reads
  neither view past its end (the storage after them holds 127 or NaN, which
  a stray read would carry into the patches); both modes against their
  plain versions, a query of zeros among them (the scale's 1e-8 floor)."""
  bt, h, w, c, n = 3, 13, 11, 128, 21
  grid, query, cy, cx = _corr_args(cuda, dtype, bt, h, w, c, n)
  query[1, 3] = 0
  gq, gs = corr_tents.quantize_per_position(grid)
  gq_frame, fs = corr_tents.quantize_per_frame(grid)
  if what == "grid":
    store = torch.full((2, gq.numel() + 8), 127, dtype=torch.int8, device=cuda)
    views = [store[k, 4:4 + gq.numel()].view(gq.shape) for k in range(2)]
    views[0].copy_(gq)
    views[1].copy_(gq_frame)
    gq, gq_frame = views
    assert gq.data_ptr() % 16 and gq_frame.data_ptr() % 16
  else:
    off = 4 // query.element_size()
    store = torch.full((query.numel() + 2 * off,), float("nan"), device=cuda,
                       dtype=query.dtype)
    query = store[off:off + query.numel()].view(query.shape)
    query.copy_(_corr_args(cuda, dtype, bt, h, w, c, n)[1])
    query[1, 3] = 0
    assert query.data_ptr() % 16
  assert corr_tents.q8_launch_plan(bt, h, w, c, n, aligned=False)["loop"] == "words"
  for out, ref in (
      (corr_tents.corr_tent_patches_prequantized_per_position(gq, gs, query, cy, cx, 7),
       corr_tents.corr_tent_patches_prequantized_per_position_reference(
           gq, gs, query, cy, cx, 7)),
      (corr_tents.corr_tent_patches_prequantized(gq_frame, fs, query, cy, cx, 7),
       corr_tents.corr_tent_patches_prequantized_reference(
           gq_frame, fs, query, cy, cx, 7))):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and not out[1, :, :, 3].any()
    torch.testing.assert_close(
        out, ref, rtol=CORR_Q8_RTOL, atol=CORR_Q8_RTOL * float(ref.abs().max()))


# quantize_rows against its plain version `_quantize_lastdim`, bit for bit in
# the int8 values and the scales: rows of mixed magnitude, values on exact
# half steps (round half to even), a row of zeros (the amax floor); rows of
# a power of two of 16-byte pieces (several rows a warp step: C = 16, 32,
# 64, 128; a row over 1 to 8 steps: 256, 512, 2048 in bf16), rows of no
# power of two (C = 40, 6, 1536: one value a lane) and a base that is not
# 16-byte aligned (one value a lane); row counts that are not a multiple of
# the rows a warp takes (c128: 105 rows, 8 a warp in bf16 and 4 in
# float32; c64_ragged: 13, 16 and 8; c256_ragged: 35, 4 and 2).
QUANTIZE_SHAPES = {
    "c256": (2, 9, 30, 256), "c128": (3, 7, 5, 128), "c40": (5, 70, 40),
    "c16": (4, 11, 16), "c32": (3, 9, 32), "c6": (7, 6),
    "c64_ragged": (13, 64), "c256_ragged": (7, 5, 256), "c512": (9, 512),
    "c1536": (5, 1536), "c2048": (3, 2048),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(QUANTIZE_SHAPES.values()),
                         ids=list(QUANTIZE_SHAPES))
@pytest.mark.parametrize("kind", ["random", "halves", "offset"])
def test_quantize_rows_kernel_bit_equal(cuda, dtype, shape, kind):
  rng = np.random.RandomState(len(shape) + shape[-1])
  x = rng.randn(*shape).astype(np.float32)
  x *= np.exp(rng.randn(*shape[:-1], 1) * 2).astype(np.float32)
  if kind == "halves":
    x = (rng.randint(-254, 255, shape) / 2.0).astype(np.float32)
    x[..., 0] = 127.0
    x.reshape(-1, shape[-1])[0] = 0.0
  v = torch.from_numpy(x).to(cuda, DTYPES[dtype])
  if kind == "offset":
    v = torch.cat([v.reshape(-1)[:1], v.reshape(-1)]).narrow(0, 1, v.numel())
    v = v.view(shape)
    assert v.data_ptr() % 16
  before = corr_tents.LAUNCHES_QUANTIZE
  q, scale = corr_tents.quantize_per_position(v)
  torch.cuda.synchronize()
  assert corr_tents.LAUNCHES_QUANTIZE == before + 1
  q_ref, scale_ref = corr_tents._quantize_lastdim(v)  # pylint: disable=protected-access
  assert q.dtype == torch.int8 and scale.dtype == torch.float32
  assert q.shape == v.shape and scale.shape == v.shape[:-1]
  torch.testing.assert_close(q, q_ref, rtol=0, atol=0)
  torch.testing.assert_close(scale, scale_ref, rtol=0, atol=0)
  assert int(q.abs().max()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "b,t,valid_len,c,hid", [(3, 13, None, 64, 256), (5, 37, 30, 128, 512),
                            (2, 150, 141, 48, 208), (2, 9, 7, 512, 2048),
                            (4, 70, 65, 96, 336), (1, 5, None, 16, 16)],
    ids=["one_tile", "tiles_valid_len", "ragged_widths", "served_width",
         "hid_not_128", "tiny"],
)
def test_mixer_block_q8_kernel_matches_plain(cuda, dtype, causal, b, t,
                                             valid_len, c, hid):
  """The w8a8 block against its plain version. Limit per element:
  `fused_mixer_block.q8_error_limit` (the full-precision allowance plus four
  deviations of a quarter of a row's hidden values one int8 step apart). The
  int8 operand and hidden themselves: at most a quarter of them apart at
  all, and at most 1% more than one step apart (a row whose scale differs
  moves its large values by a few steps)."""
  rng = np.random.RandomState(1)
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
  args = [
      f(b, t, c) * 0.5, f(c) * 0.2 + 1, f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1,
      f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1, f(c) * 0.2 + 1,
      f(c, hid) * 0.1, f(hid) * 0.1, f(hid, c) * 0.1, f(c) * 0.1,
  ]
  args = [a.to(cuda, DTYPES[dtype]) for a in args]
  before = (fused_mixer_block.LAUNCHES, fused_mixer_block.LAUNCHES_Q8)
  out = fused_mixer_block.mixer_block(*args, causal, valid_len, quantized=True)
  torch.cuda.synchronize()
  assert (fused_mixer_block.LAUNCHES, fused_mixer_block.LAUNCHES_Q8) == (
      before[0], before[1] + 1)
  ref = fused_mixer_block.mixer_block_reference(
      *args, causal, valid_len, quantized=True)
  limit, xq_ref, hq_ref = fused_mixer_block.q8_error_limit(
      *args, causal, valid_len)
  err = (out.float() - ref.float()).abs()
  assert torch.isfinite(out.float()).all()
  assert (err <= limit).all(), float((err / limit.clamp_min(1e-30)).max())
  if valid_len is not None:
    assert not out[:, valid_len:].any()

  # The kernels' own int8 tensors, rows < valid_len.
  x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2 = args
  qweights = (*mixer_math.quantize_weight_cols(w1),
              *mixer_math.quantize_weight_cols(w2))
  scratch = {}
  fused_mixer_block._launch_q8(  # pylint: disable=protected-access
      x, g1, wu, bu, wm, bm, g2, b1, b2, qweights, causal, valid_len, scratch)
  torch.cuda.synchronize()
  tv = t if valid_len is None else valid_len
  for name, ref_q in (("xq", xq_ref), ("hq", hq_ref)):
    got = scratch[name].reshape(b, t, -1)[:, :tv].reshape(ref_q.shape)
    step = (got.int() - ref_q.int()).abs()
    assert float((step > 0).float().mean()) <= 0.25, name
    assert float((step > 1).float().mean()) <= 0.01, name


def test_q8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
  grid = torch.zeros(1, 4, 4, 6, device=cuda)  # C not a multiple of 4
  query = torch.zeros(1, 2, 6, device=cuda)
  centre = torch.zeros(1, 2, device=cuda)
  with pytest.raises(ValueError, match="multiple of 4"):
    corr_tents.corr_tent_patches(grid, query, centre, centre, 7, True)
  x = torch.zeros(1, 4, 8, device=cuda)  # C not a multiple of 16
  p = lambda *s: torch.zeros(*s, device=cuda)
  with pytest.raises(ValueError, match="multiples of 16"):
    fused_mixer_block.mixer_block(
        x, p(8), p(3, 1, 32), p(32), p(3, 1, 32), p(32), p(8), p(8, 32),
        p(32), p(32, 8), p(8), quantized=True)
  # H not a multiple of 16; C over the 512 output columns the MLP holds.
  x = torch.zeros(1, 4, 32, device=cuda)
  with pytest.raises(ValueError, match="multiples of 16"):
    fused_mixer_block.mixer_block(
        x, p(32), p(3, 1, 128), p(128), p(3, 1, 128), p(128), p(32), p(32, 24),
        p(24), p(24, 32), p(32), quantized=True)
  x = torch.zeros(1, 4, 528, device=cuda)
  with pytest.raises(ValueError, match="output columns"):
    fused_mixer_block.mixer_block(
        x, p(528), p(3, 1, 2112), p(2112), p(3, 1, 2112), p(2112), p(528),
        p(528, 64), p(64), p(64, 528), p(528), quantized=True)


# ------------------------------------------------------- int8 ExtraConvs

# (n, h, w, C_in, C_out): conv_up and conv_out of C = 128 and 256, odd and
# unequal H and W, a pixel count that is not a multiple of the 128-row tile.
CONV_Q8_SHAPES = [(3, 9, 7, 128, 512), (2, 7, 9, 512, 128),
                  (2, 11, 13, 256, 1024), (1, 5, 6, 1024, 256),
                  (3, 13, 11, 48, 272), (1, 17, 19, 160, 48),
                  (1, 1, 1, 16, 16), (4, 1, 1, 32, 272)]


def _conv_q8_args(cuda, dtype, n, h, w, cin, cout, seed=0):
  rng = np.random.RandomState(seed)
  x = rng.randn(n, h, w, cin).astype(np.float32)
  x *= np.exp(rng.randn(n, 1, 1, 1)).astype(np.float32)
  k = (rng.randn(cout, cin, 3, 3) / (3 * cin**0.5)).astype(np.float32)
  b = (rng.randn(cout) * 0.1).astype(np.float32)
  x = torch.from_numpy(x).to(cuda, DTYPES[dtype]).permute(0, 3, 1, 2)
  return x, torch.from_numpy(k).to(cuda), torch.from_numpy(b).to(cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout", CONV_Q8_SHAPES,
                         ids=["up128", "out128", "up256", "out256",
                              "ragged_rows_and_cols", "n1_two_k_steps",
                              "one_pixel_n1", "one_pixel_frames"])
def test_conv2d_q8_kernel_matches_plain(cuda, dtype, n, h, w, cin, cout):
  """Both sides quantize the same floats with the same division and round
  the same exact integers through the same float32 products in the same
  order: bit-equal outputs are expected. The limit is one rounding of the
  output (1e-6 relative in float32, a bf16 step of 2^-7 relative)."""
  x, k, b = _conv_q8_args(cuda, dtype, n, h, w, cin, cout)
  before = (qconv.LAUNCHES_Q8, fused_extra_convs.LAUNCHES)
  out = qconv.conv2d_q8(x, k, b)
  torch.cuda.synchronize()
  assert (qconv.LAUNCHES_Q8, fused_extra_convs.LAUNCHES) == (before[0] + 1,
                                                             before[1])
  ref = qconv.conv2d_q8_math(x, k, b)
  assert out.shape == ref.shape == (n, cout, h, w) and out.dtype == x.dtype
  rel = 1e-6 if dtype == "float32" else 2.0**-7
  err = (out.float() - ref.float()).abs()
  assert (err <= rel * ref.float().abs() + 1e-30).all(), float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin", [(3, 13, 11, 48), (2, 1, 1, 16)],
                         ids=["ragged", "one_pixel"])
def test_conv2d_q8_padded_operand(cuda, dtype, n, h, w, cin):
  """The kernel's int8 operand: zero-ringed frames [N, H+2, W+2, C_in] whose
  inside equals the plain quantizer's output and whose frame scales are the
  plain version's, bit for bit (the same IEEE division)."""
  x, k, b = _conv_q8_args(cuda, dtype, n, h, w, cin, 32)
  scratch = {}
  qconv._launch_q8(x, qconv.quantize_conv_weight(k), b, scratch)  # pylint: disable=protected-access
  torch.cuda.synchronize()
  xq_ref, xs_ref = qconv.quantize_per_frame(x.permute(0, 2, 3, 1))
  assert scratch["xq_padded"].shape == (n, h + 2, w + 2, cin)
  assert torch.equal(scratch["xq"], xq_ref)
  assert torch.equal(scratch["xs"], xs_ref)
  ring = scratch["xq_padded"].clone()
  ring[:, 1:-1, 1:-1] = 0
  assert not ring.any()


# (n, h, w, C): K6 at C = 128 and 256 (M = 4C), odd H and W; the served
# width at a few frames; a ragged W with C = 48 (a partial K panel: 9C is no
# multiple of 64); C = 16 with frames smaller than a 64-pixel block, so a
# block spans several frames. Every pixel count but 4x8x10 is no multiple of
# the 64- and 128-pixel blocks.
EXTRA_Q8_SHAPES = [(2, 9, 7, 128), (1, 11, 13, 256), (3, 5, 5, 128),
                   (4, 8, 10, 256), (2, 6, 37, 48), (5, 3, 4, 16)]
# The int8 hidden of K6 against the plain version's: at most this share one
# step apart at all, this share more than one step apart, and
# `fused_extra_convs.Q8_PIXEL_FLIP_SHARE` of any one pixel's values (the
# share `q8_error_limit` assumes). Only float32 noise separates the two in
# either model dtype (the layer is float32 from the LayerNorm to the output).
EXTRA_Q8_FLIPS = dict(share=5e-3, far=1e-4)


def _extra_convs_args(cuda, dtype, n, h, w, c, seed=1):
  rng = np.random.RandomState(seed)
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(cuda)
  m = 4 * c
  x = (f(n, h, w, c) * 0.5).to(DTYPES[dtype])
  return [x, f(c) * 0.2 + 1, f(c) * 0.1, f(3, 3, c, m) / (3 * c**0.5),
          f(m) * 0.1, f(3, 3, m, c) / (3 * m**0.5), f(c) * 0.1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c", EXTRA_Q8_SHAPES,
                         ids=["c128", "c256", "c128_5x5", "served_width",
                              "c48_ragged_w", "c16_small_frames"])
def test_extra_convs_q8_kernel_matches_plain(cuda, dtype, n, h, w, c):
  """K6 against its plain version: the output within
  `fused_extra_convs.q8_error_limit`, the kernel's own int8 hidden within
  EXTRA_Q8_FLIPS of the plain version's."""
  x, g, bln, wu, bu, wo, bo = args = _extra_convs_args(cuda, dtype, n, h, w, c)
  qweights = fused_extra_convs.quantized_weights(wu, wo)
  before = (qconv.LAUNCHES_Q8, fused_extra_convs.LAUNCHES)
  out = fused_extra_convs.extra_convs_layer(*args, True)
  torch.cuda.synchronize()
  assert (qconv.LAUNCHES_Q8, fused_extra_convs.LAUNCHES) == (before[0],
                                                             before[1] + 1)
  ref = fused_extra_convs.extra_convs_layer_reference(*args, True)
  limit, hq_ref = fused_extra_convs.q8_error_limit(x, g, bln, bu, bo, qweights)
  err = (out.float() - ref.float()).abs()
  assert torch.isfinite(out.float()).all()
  assert (err <= limit).all(), float((err / limit).max())
  scratch = {}
  fused_extra_convs._launch(x, g, bln, bu, bo, qweights, scratch)  # pylint: disable=protected-access
  torch.cuda.synchronize()
  step = (scratch["hq"].int() - hq_ref.int()).abs()
  assert float((step > 0).float().mean()) <= EXTRA_Q8_FLIPS["share"]
  assert float((step > 1).float().mean()) <= EXTRA_Q8_FLIPS["far"]
  assert (float((step > 0).float().mean(-1).max())
          <= fused_extra_convs.Q8_PIXEL_FLIP_SHARE)


@pytest.mark.parametrize("quantized", [True, "per_pixel"])
def test_extra_convs_module_launches_its_kernels(cuda, quantized, monkeypatch):
  """On the card the module takes a kernel for every layer: K6 where the
  per-pixel gate holds (lowered here to this small input), the per-frame
  convolution (two per layer) elsewhere."""
  monkeypatch.setattr(fused_extra_convs, "_MIN_FUSED_ELEMENTS", 1)
  model = layers.ExtraConvs(channels=128, num_layers=2, quantized=quantized)
  torch.manual_seed(0)
  for p in model.parameters():
    torch.nn.init.normal_(p, std=0.02)
  model = model.to(cuda)
  x = torch.randn(2, 128, 6, 5, device=cuda)
  before = (qconv.LAUNCHES_Q8, fused_extra_convs.LAUNCHES)
  with torch.no_grad():
    out = model(x)
    ref = model.cpu()(x.cpu())
  torch.cuda.synchronize()
  got = (qconv.LAUNCHES_Q8 - before[0], fused_extra_convs.LAUNCHES - before[1])
  assert got == ((0, 2) if quantized == "per_pixel" else (4, 0))
  assert float((out.cpu() - ref).abs().max()) < 0.05


# K6f, the full-precision layer, against its plain version: fp32 within the
# port's 1e-4 (absolute and relative; the plain version's float32
# convolutions with TF32 off), bf16 within `fused_extra_convs.fp_error_limit`.
# C = 128 and 256 (the served width, M = 4C), odd H and W, a ragged W whose
# pixel count is no multiple of the 128-row tile, single-pixel frames, and
# C = 48 (in bf16 a K step of 64 values past C).
EXTRA_FP_SHAPES = [(2, 9, 7, 128), (1, 11, 13, 256), (3, 5, 5, 64),
                   (2, 6, 37, 32), (3, 1, 1, 16), (2, 7, 6, 48)]


def _extra_convs_fp_check(args):
  """(kernel output, its largest error over fp_error_limit)."""
  out = fused_extra_convs.extra_convs_layer(*args, False)
  torch.cuda.synchronize()
  ref = fused_extra_convs.extra_convs_layer_reference(*args, False)
  limit = fused_extra_convs.fp_error_limit(*args)
  assert torch.isfinite(out.float()).all()
  return out, ref, limit, float(((out.float() - ref.float()).abs() / limit).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c", EXTRA_FP_SHAPES,
                         ids=["c128", "c256", "c64_5x5", "ragged_w",
                              "one_pixel", "c48"])
def test_extra_convs_fp_kernel_matches_plain(cuda, dtype, n, h, w, c,
                                             monkeypatch):
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  args = _extra_convs_args(cuda, dtype, n, h, w, c)
  before = (fused_extra_convs.LAUNCHES_FP, fused_extra_convs.LAUNCHES,
            qconv.LAUNCHES_Q8)
  out, _, _, over = _extra_convs_fp_check(args)
  assert (fused_extra_convs.LAUNCHES_FP, fused_extra_convs.LAUNCHES,
          qconv.LAUNCHES_Q8) == (before[0] + 1, before[1], before[2])
  assert out.shape == args[0].shape and out.dtype == args[0].dtype
  assert over <= 1.0, over


@pytest.mark.parametrize("n,h,w,c", [(2, 9, 7, 128), (4, 20, 20, 64),
                                     (3, 1, 1, 16)],
                         ids=["c128", "many_tiles", "one_pixel"])
def test_extra_convs_fp_bf16_padded_slabs(cuda, n, h, w, c):
  """K6f in bf16 writes t and the hidden as zero-ringed frames: both rings
  are zero (conv_up's epilogue writes the hidden's, no memset), t inside is
  bf16(t32), and the hidden inside is, but for a share FP_HIDDEN_FLIP_SHARE
  a bf16 step apart (the sums' order), gelu(conv_up(t) + bu) of the
  kernel's own t; the output equals the float64 emulation of the
  formulation (`fp_padded_slab`) within `fp_error_limit`."""
  args = _extra_convs_args(cuda, "bfloat16", n, h, w, c)
  x, g, bln, wu, bu = args[:5]
  scratch = {}
  out = fused_extra_convs._launch_fp(x.contiguous(), *args[1:], scratch=scratch)  # pylint: disable=protected-access
  torch.cuda.synchronize()
  ring = torch.ones(n, h + 2, w + 2, dtype=torch.bool, device=cuda)
  ring[:, 1:h + 1, 1:w + 1] = False
  assert scratch["t_padded"].shape == (n, h + 2, w + 2, c)
  assert scratch["hidden_padded"].shape == (n, h + 2, w + 2, 4 * c)
  assert not scratch["t_padded"][ring].float().any()
  assert not scratch["hidden_padded"][ring].float().any()
  t32 = scratch["t32"]
  torch.testing.assert_close(scratch["t_padded"][:, 1:h + 1, 1:w + 1],
                             t32.bfloat16(), rtol=0, atol=0)
  hidden = mixer_math.gelu(fused_extra_convs._conv_fp(t32.bfloat16(), wu, bu))  # pylint: disable=protected-access
  apart = (scratch["hidden"] != hidden.bfloat16()).float().mean()
  assert float(apart) <= fused_extra_convs.FP_HIDDEN_FLIP_SHARE
  emulated, _ = fused_extra_convs.fp_padded_slab(*(a.cpu() for a in args))
  limit = fused_extra_convs.fp_error_limit(*(a.cpu() for a in args))
  err = (out.float().cpu() - emulated.float()).abs()
  assert (err <= limit).all(), float((err / limit).max())


@pytest.mark.parametrize("n,h,w,c", [(2, 9, 7, 128), (4, 20, 20, 64),
                                     (3, 1, 1, 16), (2, 7, 6, 48)],
                         ids=["c128", "many_tiles", "one_pixel", "c48"])
def test_extra_convs_fp32_padded_slabs(cuda, n, h, w, c):
  """K6f in float32 writes t and the hidden as zero-ringed float32 frames:
  both rings are zero, t inside is t32 itself, and the kernel's hidden (its
  conv_up as error-compensated TF32) equals the float64 emulation of that
  arithmetic (`fp_padded_slab(terms="tf32x3")`) within 1e-4 absolute and
  relative, as its output does within `fp_error_limit`. At one-pixel frames
  and C = 48 the first frame's shifted boxes start at negative rows and a K
  step of 32 values runs past C: TMA's zeros."""
  args = _extra_convs_args(cuda, "float32", n, h, w, c)
  scratch = {}
  out = fused_extra_convs._launch_fp(args[0], *args[1:], scratch=scratch)  # pylint: disable=protected-access
  torch.cuda.synchronize()
  ring = torch.ones(n, h + 2, w + 2, dtype=torch.bool, device=cuda)
  ring[:, 1:h + 1, 1:w + 1] = False
  assert scratch["t_padded"].dtype == scratch["hidden_padded"].dtype == torch.float32
  assert scratch["hidden_padded"].shape == (n, h + 2, w + 2, 4 * c)
  assert not scratch["t_padded"][ring].any()
  assert not scratch["hidden_padded"][ring].any()
  torch.testing.assert_close(scratch["t_padded"][:, 1:h + 1, 1:w + 1],
                             scratch["t32"], rtol=0, atol=0)
  emulated, hidden = fused_extra_convs.fp_padded_slab(
      *(a.cpu() for a in args), terms="tf32x3")
  torch.testing.assert_close(scratch["hidden_padded"].cpu(), hidden,
                             rtol=1e-4, atol=1e-4)
  limit = fused_extra_convs.fp_error_limit(*(a.cpu() for a in args))
  err = (out.cpu() - emulated).abs()
  assert (err <= limit).all(), float((err / limit).max())


def test_extra_convs_fp_limit_refuses_controls_on_card(cuda, monkeypatch):
  """At the served width in fp32, the kernel passes and each faulty plain
  layer of `fp_output_controls` (the pad ring's hidden unmasked, the
  residual on bf16 t, the hidden in the other dtype) and of `fp32_controls`
  (the plain layer with TF32 matmuls on; the TF32 split without A_small .
  B_big) is refused."""
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  args = _extra_convs_args(cuda, "float32", 2, 8, 9, 256)
  _, ref, limit, over = _extra_convs_fp_check(args)
  assert over <= 1.0, over
  controls = {**fused_extra_convs.fp_output_controls(*args),
              **fused_extra_convs.fp32_controls(*args)}
  assert len(controls) == 5
  assert not torch.backends.cuda.matmul.allow_tf32
  for key, faulty in controls.items():
    assert float(((faulty - ref).abs() / limit).max()) > 1.0, key


def test_cuda_tensors_never_take_the_plain_versions(cuda, monkeypatch):
  """With the kernels' library unloadable, the ExtraConvs entries raise on
  CUDA tensors, the full-precision layer (K6f) too; the plain versions are
  never called."""
  def unloadable(*args, **kwargs):
    raise RuntimeError("library unloadable")

  def plain(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached a plain version")

  monkeypatch.setattr(_build, "load", unloadable)
  monkeypatch.setattr(qconv, "conv2d_q8_math", plain)
  monkeypatch.setattr(fused_extra_convs, "extra_convs_layer_reference", plain)
  x, k, b = _conv_q8_args(cuda, "float32", 1, 4, 4, 16, 32)
  with pytest.raises(RuntimeError, match="unloadable"):
    qconv.conv2d_q8(x, k, b)
  args = _extra_convs_args(cuda, "float32", 1, 4, 4, 16)
  with pytest.raises(RuntimeError, match="unloadable"):
    fused_extra_convs.extra_convs_layer(*args, True)
  with pytest.raises(RuntimeError, match="unloadable"):
    fused_extra_convs.extra_convs_layer(*args, False)


def test_extra_convs_wrappers_refuse_what_the_kernels_do_not_take(cuda):
  x, k, b = _conv_q8_args(cuda, "float32", 1, 4, 4, 24, 32)  # C_in % 16 != 0
  with pytest.raises(ValueError, match="multiples of 16"):
    qconv.conv2d_q8(x, k, b)
  args = _extra_convs_args(cuda, "float32", 1, 4, 4, 24)
  with pytest.raises(ValueError, match="multiple of 16"):
    fused_extra_convs.extra_convs_layer(*args, True)
  with pytest.raises(ValueError, match="multiples of 16"):
    fused_extra_convs.extra_convs_layer(*args, False)
  # K6: a hidden width no multiple of 64; a patch too wide for shared memory.
  x, g, bln, wu, bu, wo, bo = _extra_convs_args(cuda, "float32", 1, 4, 4, 32)
  with pytest.raises(ValueError, match="multiple of 64"):
    fused_extra_convs.extra_convs_layer(
        x, g, bln, wu[..., :96], bu[:96], wo[:, :, :96], bo, True)
  args = _extra_convs_args(cuda, "float32", 1, 2, 2, 288)
  with pytest.raises(ValueError, match="shared memory"):
    fused_extra_convs.extra_convs_layer(*args, True)


@pytest.mark.parametrize("kernel", ["K4", "K6"])
def test_q8_kernels_keep_the_float32_hidden_off_device_memory(cuda, kernel):
  """On the main path (no scratch), one call's peak allocation above its
  inputs and output stays under the float32 hidden's rows * hidden * 4
  bytes: neither wrapper allocates it, and the kernels keep it on chip."""
  if kernel == "K4":
    b, t, c, hid = 8, 250, 512, 2048
    rng = np.random.RandomState(2)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        cuda, torch.bfloat16)
    args = [f(b, t, c), f(c), f(3, 1, 4 * c), f(4 * c), f(3, 1, 4 * c),
            f(4 * c), f(c), f(c, hid) * 0.05, f(hid), f(hid, c) * 0.05, f(c)]
    qweights = (*mixer_math.quantize_weight_cols(args[7]),
                *mixer_math.quantize_weight_cols(args[9]))
    call = lambda: fused_mixer_block.mixer_block(
        *args, quantized=True, qweights=qweights)
    rows = b * t
  else:
    x, g, bln, wu, bu, wo, bo = _extra_convs_args(cuda, "bfloat16", 16, 32, 32, 256)
    qweights = fused_extra_convs.quantized_weights(wu, wo)
    call = lambda: fused_extra_convs.extra_convs_layer(
        x, g, bln, None, bu, None, bo, True, qweights=qweights)
    rows, hid = x.shape[0] * x.shape[1] * x.shape[2], 4 * x.shape[-1]
  call()  # the kernels' library is loaded before the measured call
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  out = call()
  torch.cuda.synchronize()
  over = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
  assert over < rows * hid * 4, (over, rows * hid * 4)


# K5, the linear scan: the kernel makes the plain version's two roundings per
# step (__fmul_rn, __fadd_rn) and the same cast of y, so the two are equal
# bit for bit at any shape: the served one ([b*(1024+256), 50, 768]), widths
# that are no multiple of 4 (scalar loads) and a single row.
SCAN_SHAPES = [(1280, 50, 768), (3, 12, 130), (5, 7, 3), (1, 33, 6)]


def _scan_args(cuda, dtype, shape, carried, seed=0):
  b, t, c = shape
  gen = torch.Generator(device=cuda).manual_seed(seed)
  tdt = DTYPES[dtype]
  x = torch.randn(b, t, c, device=cuda, generator=gen).to(tdt)
  a = (torch.rand(b, t, c, device=cuda, generator=gen) * 0.3 + 0.69).to(tdt)
  h0 = torch.randn(b, c, device=cuda, generator=gen) if carried else (
      torch.zeros(b, c, device=cuda))
  return x, a, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["h0_zero", "h0_carried"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_linear_scan_kernel_bit_equal(cuda, dtype, carried, shape):
  x, a, h0 = _scan_args(cuda, dtype, shape, carried)
  before = scan.LAUNCHES
  y, h_last = scan.linear_scan(x, a, h0)
  torch.cuda.synchronize()
  assert scan.LAUNCHES == before + 1
  ref_y, ref_h = scan.linear_scan_reference(x, a, h0)
  assert y.dtype == x.dtype and h_last.dtype == torch.float32
  assert torch.equal(y, ref_y)
  assert torch.equal(h_last, ref_h)
  for name, (fy, fh) in scan.scan_controls(x, a, h0).items():
    if shape[1] > 1:
      assert not (torch.equal(fy, y) and torch.equal(fh, h_last)), name


def test_linear_scan_refuses_what_the_kernel_does_not_take(cuda):
  """Inputs that require grad now run K5 and, in the backward, K5b, which
  equals the plain backward bit for bit; dtypes, shapes and layouts the
  kernels do not take still raise."""
  x, a, h0 = _scan_args(cuda, "float32", (2, 5, 8), True)
  args = [t.clone().requires_grad_() for t in (x, a, h0)]
  before = scan.BACKWARD_LAUNCHES
  y, h_last = scan.linear_scan(*args)
  dy = torch.randn_like(y)
  dh_last = torch.randn_like(h_last)
  grads = torch.autograd.grad((y, h_last), args, (dy, dh_last))
  torch.cuda.synchronize()
  assert scan.BACKWARD_LAUNCHES == before + 1
  ref = scan.linear_scan_backward_reference(dy, dh_last, a, h0, y.detach())
  for got, want in zip(grads, ref):
    assert torch.equal(got, want)
  with pytest.raises(TypeError):
    scan.linear_scan(x, a.bfloat16(), h0)
  with pytest.raises(TypeError):
    scan.linear_scan(x, a, h0.bfloat16())
  with pytest.raises(ValueError, match="contiguous"):
    scan.linear_scan(x.transpose(0, 1).contiguous().transpose(0, 1), a, h0)
  with pytest.raises(TypeError):
    scan.linear_scan(x.half(), a.half(), h0)
  with pytest.raises(ValueError, match="shapes"):
    scan.linear_scan(x, a[:, :4].contiguous(), h0)
  with pytest.raises(TypeError):
    scan._launch_backward(dy.bfloat16(), None, a, h0, y.detach())  # pylint: disable=protected-access
  with pytest.raises(ValueError):
    scan._launch_backward(dy, dh_last[:1].contiguous(), a, h0, y.detach())  # pylint: disable=protected-access


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh_last", [False, True], ids=["no_dh_last", "dh_last"])
@pytest.mark.parametrize("carried", [False, True], ids=["h0_zero", "h0_carried"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_linear_scan_backward_kernel_bit_equal(cuda, dtype, carried, dh_last,
                                               shape):
  """K5b against the plain backward, bit for bit, beside the faulty plain
  backwards that differ."""
  x, a, h0 = _scan_args(cuda, dtype, shape, carried, seed=1)
  with torch.no_grad():
    y, _ = scan.linear_scan(x, a, h0)
  gen = torch.Generator(device=cuda).manual_seed(2)
  dy = torch.randn(shape, device=cuda, generator=gen).to(DTYPES[dtype])
  g_last = (torch.randn(shape[0], shape[2], device=cuda, generator=gen)
            if dh_last else None)
  before = scan.BACKWARD_LAUNCHES
  got = scan._launch_backward(dy, g_last, a, h0, y)  # pylint: disable=protected-access
  torch.cuda.synchronize()
  assert scan.BACKWARD_LAUNCHES == before + 1
  ref = scan.linear_scan_backward_reference(dy, g_last, a, h0, y)
  assert [t.dtype for t in got] == [DTYPES[dtype], DTYPES[dtype], torch.float32]
  for g, r in zip(got, ref):
    assert torch.equal(g, r)
  if shape[1] > 1 and dh_last:
    for name, faulty in scan.scan_backward_controls(dy, g_last, a, h0, y).items():
      # Rounding h0 to bf16 moves da[0] by at most 2^-9 of it before da's
      # own bf16 rounding, so it shows in about a quarter of the elements:
      # look for it where h0 has 64 or more.
      if name == "h0_unrounded" and (not carried or shape[0] * shape[2] < 64):
        continue
      assert not all(torch.equal(f, g) for f, g in zip(faulty, got)), name


def test_rglru_gradients_match_cpu(cuda):
  """The RG-LRU's gradients on the card (K5, K5b, the clipped sqrt) against
  its CPU run (the plain scans), float32: the products sum in other
  orders."""
  torch.manual_seed(0)
  mod = rglru.RGLRU(32, 2)
  for p in mod.parameters():
    torch.nn.init.normal_(p, std=0.3)
  x = torch.randn(3, 9, 32, requires_grad=True)
  h0 = torch.randn(3, 32, requires_grad=True)
  y, h = mod(x, h0)
  ref = torch.autograd.grad((y * y).sum() + h.sum(), [x, h0, *mod.parameters()])
  mod = mod.to(cuda)
  xc = x.detach().to(cuda).requires_grad_()
  hc = h0.detach().to(cuda).requires_grad_()
  before = scan.BACKWARD_LAUNCHES
  y, h = mod(xc, hc)
  got = torch.autograd.grad((y * y).sum() + h.sum(), [xc, hc, *mod.parameters()])
  assert scan.BACKWARD_LAUNCHES == before + 1
  for g, r in zip(got, ref):
    torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-5)


def test_rglru_launches_the_scan(cuda):
  """The RG-LRU on the card runs K5 for a sequence and the one-step formula
  (no launch) for a single frame, and matches its CPU run."""
  torch.manual_seed(0)
  mod = rglru.RGLRU(32, 2)
  for p in mod.parameters():
    torch.nn.init.normal_(p, std=0.3)
  x = torch.randn(3, 9, 32)
  h0 = torch.randn(3, 32)
  with torch.no_grad():
    ref_y, ref_h = mod(x, h0)
    mod = mod.to(cuda)
    before = scan.LAUNCHES
    y, h = mod(x.to(cuda), h0.to(cuda))
    torch.cuda.synchronize()
    assert scan.LAUNCHES == before + 1
    mod(x[:, :1].to(cuda), h0.to(cuda))
    assert scan.LAUNCHES == before + 1
  torch.testing.assert_close(y.cpu(), ref_y, rtol=1e-5, atol=1e-5)
  torch.testing.assert_close(h.cpu(), ref_h, rtol=1e-5, atol=1e-5)


# ------------------------------------------------ int8 streams, evaluation


def _flax_tree(model):
  """The Flax-layout tree of a port TAPIR's weights (the inverse of
  `checkpoints.convert.flax_to_state_dict`), for the predictors."""
  tree = {}
  for key, value in model.state_dict().items():
    *path, leaf = key.split(".")
    arr = value.detach().cpu().numpy()
    if leaf == "weight":
      leaf = "kernel"
      arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else (
          arr.T if arr.ndim == 2 else arr)
    node = tree
    for p in path:
      node = node.setdefault(p, {})
    node[leaf] = np.ascontiguousarray(arr)
  return tree


def _small_tapir(config_fn, **overrides):
  from tapnet_tpu_torch.models import tapir

  torch.manual_seed(0)
  model = tapir.TAPIR(config_fn(**dict(dict(
      blocks_per_group=(1, 1, 1, 1), highres_dim=16, lowres_dim=32,
      mixer_hidden_dim=32, num_mixer_blocks=2, initial_resolution=(64, 64),
      num_pips_iter=2), **overrides)))
  for p in model.parameters():
    torch.nn.init.normal_(p, std=0.05)
  return model.config, _flax_tree(model)


def test_streaming_q8_mixer_block_matches_cpu(cuda):
  """The w8a8 causal MixerBlock streaming with a cache (warm-up, then three
  one-frame steps; its MLP `mixer_math.mlp_math_q8`, float64 products of the
  int8 values) on the card against its CPU run. Float32 noise may move an
  activation across an int8 rounding boundary, which moves the outputs of
  that token by a step's worth (about 1e-3 here): at most 1% of the
  outputs past 1e-4, none past 2e-2."""
  torch.manual_seed(0)
  block = layers.MixerBlock(64, causal=True, quantized=True)
  for p in block.parameters():
    torch.nn.init.normal_(p, std=0.1)
  clip, steps = torch.randn(8, 4, 64), torch.randn(3, 8, 1, 64)

  def stream(block, device):
    outs = []
    with torch.no_grad():
      y, cache = block(clip.to(device), None, True)
      outs.append(y)
      for x in steps:
        y, cache = block(x.to(device), cache, True)
        outs.append(y)
    return torch.cat([o.cpu() for o in outs], 1)

  ref = stream(block, "cpu")
  got = stream(block.to(cuda), cuda)
  diff = (got - ref).abs()
  assert (diff > 1e-4).float().mean() <= 0.01 and diff.max() <= 2e-2


@pytest.mark.parametrize("name", ["a", "c"])
def test_online_int8_stream_matches_cpu(cuda, name):
  """OnlineTapirPredictor in int8 configurations a and c (a small causal
  BootsTAPIR, random weights): init, three steps and add_points on the card
  against the CPU run; c's steps launch K2 and X, and never K6. Limits: the
  int8 CPU tests' (tests/test_torch_tapir.py INT8_TOL), the two sides
  differing by float32 noise and the int8 steps it moves."""
  from tapnet_tpu_torch.inference import OnlineTapirPredictor
  from tapnet_tpu_torch.models import tapir
  from tools.golden_clip import INT8_CONFIGS

  config, params = _small_tapir(tapir.causal_bootstapir_config,
                                **INT8_CONFIGS[name])
  tol = {"a": dict(tracks=0.03, logits=2e-2), "c": dict(tracks=0.3, logits=0.1)}[name]
  rng = np.random.RandomState(0)
  video = (rng.rand(1, 4, 64, 64, 3) * 2 - 1).astype(np.float32)
  qp = np.stack([np.zeros(6), rng.rand(6) * 56 + 4, rng.rand(6) * 56 + 4],
                -1)[None].astype(np.float32)

  def stream(device):
    p = OnlineTapirPredictor(params, config, device=device)
    p.init(video[:, 0], qp)
    outs = [p.step(video[:, t]) for t in range(1, 3)]
    p.add_points(video[:, 2], qp[:, :2] + np.float32([0, 2, -3]), [1, 4])
    outs.append(p.step(video[:, 3]))
    return outs

  ref = stream("cpu")
  before = {k: getattr(m, a) for k, (m, a) in {
      "k2": (corr_tents, "LAUNCHES_Q8_FRAME"), "x": (qconv, "LAUNCHES_Q8"),
      "k6": (fused_extra_convs, "LAUNCHES")}.items()}
  got = stream("cuda")
  launched = {"k2": corr_tents.LAUNCHES_Q8_FRAME - before["k2"],
              "x": qconv.LAUNCHES_Q8 - before["x"],
              "k6": fused_extra_convs.LAUNCHES - before["k6"]}
  assert launched["k2"] == 3 * 3 * config.num_pips_iter and launched["k6"] == 0
  assert (launched["x"] > 0) == (name == "c")
  for ours, theirs in zip(got, ref):
    np.testing.assert_allclose(ours["tracks"], theirs["tracks"], rtol=0,
                               atol=tol["tracks"])
    for key in ("occlusion", "expected_dist"):
      np.testing.assert_allclose(ours[key], theirs[key], rtol=0,
                                 atol=tol["logits"])


def test_evaluate_dataset_on_card_matches_cpu(cuda, tmp_path):
  """`evaluate_dataset` over two exported 8-frame 64x64 videos with a small
  BootsTAPIR (random weights, fp32, TF32 off): the card's metrics against
  the CPU's, within 1e-3 (fp32 summation order moves only point-frames
  within about 1e-3 px of a threshold)."""
  from tapnet_tpu_torch.data import synthetic
  from tapnet_tpu_torch.inference import TapirPredictor
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.tapvid import datasets, evaluate

  torch.backends.cudnn.allow_tf32 = False
  synthetic.export_npz(str(tmp_path), 2, seed=3, num_frames=8, height=64,
                       width=64, num_queries=12)
  config, params = _small_tapir(tapir.bootstapir_config)

  def run(device):
    return evaluate.evaluate_dataset(
        TapirPredictor(params, config, query_chunk_size=16, device=device),
        datasets.create_kubric_dataset(str(tmp_path), "strided", (64, 64)),
        "strided", verbose=False)

  try:
    ref, got = run("cpu"), run("cuda")
  finally:
    torch.backends.cudnn.allow_tf32 = True
  assert set(got) == set(ref) and len(got) == 13
  for k, v in ref.items():
    assert abs(got[k] - v) <= 1e-3, (k, got[k], v)


def test_in_train_eval_on_card(cuda, tmp_path, monkeypatch, capsys):
  """`training.run --eval_dir` on the card (a small TAPNext, one step, two
  exported videos): the evaluation runs the module's own weights through
  the linear scan (K5), and its scalars reach the JSONL with kind
  "eval"."""
  import dataclasses
  import json

  from tapnet_tpu_torch import configs
  from tapnet_tpu_torch.data import synthetic
  from tapnet_tpu_torch.models import ssm_vit
  from tapnet_tpu_torch.tapvid import evaluate
  from tapnet_tpu_torch.training import run

  eval_dir = str(tmp_path / "eval")
  synthetic.export_npz(eval_dir, 2, seed=4, num_frames=4, height=32, width=32,
                       num_queries=3)
  preset = configs.REGISTRY["tapnext"]

  def tiny(**overrides):
    exp = preset(**overrides)
    return dataclasses.replace(
        exp, model_config=ssm_vit.SsmVitConfig(
            width=32, depth=2, mlp_dim=64, num_heads=2, image_size=(32, 32)),
        data=dataclasses.replace(exp.data, train_size=(32, 32)))

  monkeypatch.setitem(configs.REGISTRY, "tapnext", tiny)
  real, launched = evaluate.evaluate_dataset, []

  def counted(*args, **kwargs):
    before = scan.LAUNCHES
    out = real(*args, **kwargs)
    launched.append(scan.LAUNCHES - before)
    return out

  monkeypatch.setattr(evaluate, "evaluate_dataset", counted)
  run.main(["--experiment", "tapnext", "--synthetic", "--num_steps", "1",
            "--batch_size", "1", "--num_frames", "4", "--num_queries", "3",
            "--checkpoint_dir", str(tmp_path), "--eval_dir", eval_dir,
            "--eval_every", "1"])
  # One K5 launch per SSM block per video.
  assert launched == [2 * 2]
  records = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
  evals = [r for r in records if r["kind"] == "eval"]
  assert len(evals) == 1 and 0.0 <= evals[0]["average_jaccard"] <= 1.0


def test_flow_dp_on_card_matches_cpu(cuda):
  """flow_track_assist's forward DP on the card against the plain CPU run on
  a smooth random flow (64x48, 6 steps, radius 5, blocks of two offset
  rows): the same float32 operations in the same order, so the argmins
  must be equal and the costs within 1e-6 relative; and the two tracks of
  interpolate_track equal."""
  from tapnet_tpu_torch.utils import flow_track_assist

  rng = np.random.RandomState(0)
  yy, xx = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
  flows = np.stack([np.stack([np.sin(xx / 9.0 + t) * 2 + rng.randn() * 0.1,
                              np.cos(yy / 7.0 - t) * 1.5], -1)
                    for t in range(6)]).astype(np.float32)
  init = np.full((48, 64), flow_track_assist._BIG, np.float32)  # pylint: disable=protected-access
  init[20, 30] = 0.0
  old = flow_track_assist._MAX_BLOCK_ELEMENTS  # pylint: disable=protected-access
  flow_track_assist._MAX_BLOCK_ELEMENTS = 2 * 11 * 48 * 64  # pylint: disable=protected-access
  try:
    runs = [flow_track_assist._dp_forward(  # pylint: disable=protected-access
        torch.from_numpy(flows).to(dev), torch.from_numpy(init).to(dev), 5)
            for dev in (cuda, "cpu")]
  finally:
    flow_track_assist._MAX_BLOCK_ELEMENTS = old  # pylint: disable=protected-access
  (cost, arg), (ref_cost, ref_arg) = [(c.cpu().numpy(), a.cpu().numpy())
                                      for c, a in runs]
  np.testing.assert_array_equal(arg, ref_arg)
  np.testing.assert_allclose(cost, ref_cost, rtol=1e-6, atol=0)
  args = (flows, (30, 20), (40, 25), 5)
  np.testing.assert_array_equal(
      flow_track_assist.interpolate_track(*args),
      flow_track_assist.interpolate_track(*args, device="cpu"))


def test_track_many_points_on_card_matches_cpu(cuda):
  """RoboTAP's track_many_points with a small causal BootsTAPIR (random
  weights, fp32, TF32 off) on the card against the CPU run: the same query
  points, tracks within 1e-3 px, logits within 1e-3 (fp32 summation order
  through the backbone, K1 and the streaming mixer), num_pips_iter x 3
  grids of K1 launches a streamed frame, nothing visible before its query
  frame."""
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.robotap import dense_tracking

  torch.backends.cudnn.allow_tf32 = False
  config, params = _small_tapir(tapir.causal_bootstapir_config)
  video = (np.random.RandomState(1).rand(5, 64, 64, 3) * 255).astype(np.uint8)
  ref = dense_tracking.track_many_points(video, params, config, num_points=24,
                                         seed=2, device="cpu")
  before = corr_tents.LAUNCHES
  got = dense_tracking.track_many_points(video, params, config, num_points=24,
                                         seed=2)
  torch.backends.cudnn.allow_tf32 = True
  assert corr_tents.LAUNCHES - before == 5 * 3 * config.num_pips_iter
  np.testing.assert_array_equal(got["query_points"], ref["query_points"])
  np.testing.assert_allclose(got["tracks"], ref["tracks"], rtol=0, atol=1e-3)
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-3)
  qt = got["query_points"][:, 0].astype(int)
  assert not (got["visibility"] & (np.arange(5)[None] < qt[:, None])).any()


def _sp_scan_rank(rank, world, device, shape):
  """One rank of the sequence-parallel scan on the card: its part of y and
  of the gradients, and the launches of K5 and K5b it made."""
  del rank, world
  from tapnet_tpu_torch.parallel import mesh as mesh_lib
  from tapnet_tpu_torch.parallel import sequence
  mesh = mesh_lib.make_mesh()
  gen = torch.Generator(device=device).manual_seed(0)
  x = torch.randn(shape, device=device, generator=gen)
  a = torch.rand(shape, device=device, generator=gen) * 0.3 + 0.69
  h0 = torch.randn(shape[0], shape[2], device=device, generator=gen)
  gy = torch.randn(shape, device=device, generator=gen)
  part = lambda v: sequence.shard_time(v, mesh).contiguous()
  xs, as_ = part(x).requires_grad_(), part(a).requires_grad_()
  before = (scan.LAUNCHES, scan.BACKWARD_LAUNCHES)
  y, h = sequence.sequence_parallel_linear_scan(xs, as_, h0, mesh)
  ((y * part(gy)).sum() + h.sum() / mesh.size()).backward()
  torch.cuda.synchronize()
  launches = (scan.LAUNCHES - before[0], scan.BACKWARD_LAUNCHES - before[1])
  xr, ar = x.clone().requires_grad_(), a.clone().requires_grad_()
  y1, h1 = scan.linear_scan(xr, ar, h0)
  ((y1 * gy).sum() + h1.sum()).backward()
  rel = lambda got, want: float(
      (got - want).detach().abs().max() / want.detach().abs().max())
  return dict(launches=launches, y=rel(y, part(y1)), h=rel(h, h1),
              dx=rel(xs.grad, part(xr.grad)), da=rel(as_.grad, part(ar.grad)))


def test_sequence_parallel_scan_two_ranks_on_one_card(cuda):
  """`parallel.sequence.sequence_parallel_linear_scan` on 2 gloo ranks that
  share the card: each rank launches K5 twice (the local scan, the
  cumulative decay) and K5b twice, and its part of y, h_last and the
  gradients lies within 1e-5 (relative to the largest value) of one rank's
  K5 and K5b on the whole sequence."""
  from tapnet_tpu_torch.parallel import launch
  _build.build_all()
  for out in launch.run_ranks(_sp_scan_rank, 2, "gloo", "cuda", (33, 24, 130)):
    assert out["launches"] == (2, 2)
    for key in ("y", "h", "dx", "da"):
      assert out[key] <= 1e-5, (key, out)
