"""PyTorch port, kernel modules: the plain versions of corr_tent_patches,
mixer_block, conv2d_q8 and extra_convs_layer (what the wrappers run on CPU
tensors) against the JAX package's references and its Pallas kernels in
interpret mode, fp32 and bf16; the int8 quantizers bit for bit, and the plain
int8 versions (per-frame and per-position int8 correlation, w8a8 mixer block,
per-frame int8 convolution, per-pixel ExtraConvs layer) against the same.

Inputs are made with numpy from a seed and handed to both frameworks; bf16
inputs are rounded once (round-to-nearest-even in both) from the same fp32
values.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.ops import corr_tents as jax_corr
from tapnet_tpu.ops import fused_extra_convs as jax_fec
from tapnet_tpu.ops import fused_mixer_block as jax_fmb
from tapnet_tpu.ops import mixer_math as jax_mm
from tapnet_tpu.ops import qconv as jax_qconv
from tapnet_tpu_torch.models import layers
from tapnet_tpu_torch.ops import (
    corr_tents, fused_extra_convs, fused_mixer_block, mixer_math, qconv,
    tma_gemm,
)


@pytest.fixture
def interpret_kernels():
  for module in (jax_corr, jax_fmb, jax_fec):
    module.FORCE_INTERPRET = True
  yield
  for module in (jax_corr, jax_fmb, jax_fec):
    module.FORCE_INTERPRET = False


def _both(arrays, dtype):
  """numpy fp32 arrays -> (jax arrays, torch tensors) in `dtype`."""
  jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
  tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
  return (
      [jnp.asarray(a).astype(jdt) for a in arrays],
      [torch.from_numpy(a).to(tdt) for a in arrays],
  )


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------- corr-tents


def corr_inputs(seed=0, bt=3, h=12, w=10, c=8, n=5):
  """Unit-norm grid/query rows (as the model's L2-normalized features, so
  |corr| <= 1) and centres that include positions outside the grid."""
  rng = np.random.RandomState(seed)
  grid = rng.randn(bt, h, w, c).astype(np.float32)
  grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
  query = rng.randn(bt, n, c).astype(np.float32)
  query /= np.linalg.norm(query, axis=-1, keepdims=True)
  cy = (rng.rand(bt, n) * (h + 6) - 3).astype(np.float32)
  cx = (rng.rand(bt, n) * (w + 6) - 3).astype(np.float32)
  return grid, query, cy, cx


# Tolerances. fp32: only the summation order differs (1e-5 would do; 1e-4
# matches the JAX kernel tests). bf16: the correlation and the y-tent stage
# are rounded to bf16 (2^-8 relative, |corr| <= 1), so a value sitting on a
# rounding boundary may land one bf16 step (<= 2^-7) apart.
CORR_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

CORR_SHAPES = [
    dict(seed=0, bt=3, h=12, w=10, c=8, n=5),
    # H above one 32-row Pallas slab and not a multiple of it; N not a
    # multiple of 128.
    dict(seed=1, bt=2, h=39, w=9, c=16, n=130),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CORR_SHAPES, ids=["small", "tall_ragged"])
def test_corr_tents_matches_jax_reference(dtype, shape):
  (g, q, cy, cx), (tg, tq, tcy, tcx) = _both(corr_inputs(**shape), dtype)
  cy, cx = cy.astype(jnp.float32), cx.astype(jnp.float32)
  tcy, tcx = tcy.float(), tcx.float()
  ref = jax_corr._math_reference(g, q, cy, cx, 7)
  out = corr_tents.corr_tent_patches(tg, tq, tcy, tcx, 7)
  assert out.dtype == torch.float32 and out.shape == ref.shape
  tol = CORR_TOL[dtype]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_tents_matches_pallas_interpret(dtype, interpret_kernels):
  (g, q, cy, cx), (tg, tq, tcy, tcx) = _both(corr_inputs(**CORR_SHAPES[1]), dtype)
  ref = jax_corr._pallas_forward(
      g, q, cy.astype(jnp.float32), cx.astype(jnp.float32), 7
  )
  out = corr_tents.corr_tent_patches(tg, tq, tcy.float(), tcx.float(), 7)
  # The Pallas kernel also rounds each bf16 tent product before summing.
  tol = CORR_TOL[dtype]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


def test_corr_tents_cpu_does_not_launch():
  before = corr_tents.LAUNCHES
  tensors = [torch.from_numpy(a) for a in corr_inputs()]
  corr_tents.corr_tent_patches(*tensors, 7)
  assert corr_tents.LAUNCHES == before


def test_corr_tents_rejects_other_devices():
  tensors = [torch.from_numpy(a).to("meta") for a in corr_inputs()]
  with pytest.raises(ValueError, match="unsupported device"):
    corr_tents.corr_tent_patches(*tensors, 7)


# --------------------------------------------------------------- mixer block


def mixer_inputs(seed=0, b=3, t=10, c=16, hid=64, k=3, mult=4):
  rng = np.random.RandomState(seed)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  return [
      f(b, t, c) * 0.5,
      f(c) * 0.2 + 1.0,          # g1
      f(k, 1, mult * c) * 0.3,   # wu
      f(mult * c) * 0.1,         # bu
      f(k, 1, mult * c) * 0.3,   # wm
      f(mult * c) * 0.1,         # bm
      f(c) * 0.2 + 1.0,          # g2
      f(c, hid) * 0.1,           # w1
      f(hid) * 0.1,              # b1
      f(hid, c) * 0.1,           # w2
      f(c) * 0.1,                # b2
  ]


# Tolerances. fp32: summation order only (the JAX kernel tests use 2e-4).
# bf16: JAX's reference runs its elementwise chain in bf16 (each op rounds,
# 2^-8 relative) while the port's plain version keeps the temporal conv in
# fp32 and rounds once; values are O(1), so a few bf16 steps apart.
MIXER_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "t,valid_len", [(10, None), (13, None), (13, 9)],
    ids=["t10", "t13", "t13_valid9"],
)
def test_mixer_block_matches_jax_reference(dtype, causal, t, valid_len):
  jargs, targs = _both(mixer_inputs(seed=t, t=t), dtype)
  ref = jax_fmb._math_reference(*jargs, causal, valid_len)
  out = fused_mixer_block.mixer_block(*targs, causal, valid_len)
  assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
  tol = MIXER_TOL[dtype]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
  if valid_len is not None:
    assert not out[:, valid_len:].any()


@pytest.mark.parametrize("causal", [False, True])
def test_mixer_block_matches_pallas_interpret(causal, interpret_kernels):
  jargs, targs = _both(mixer_inputs(seed=5, t=13), "float32")
  ref = jax_fmb._pallas_forward(*jargs, causal, 11)
  out = fused_mixer_block.mixer_block(*targs, causal, 11)
  tol = MIXER_TOL["float32"]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_mixer_bf16_limit_covers_tpu_kernel_rounding(causal, interpret_kernels):
  """The TPU kernel rounds where the CUDA kernel does (LN1 kept in fp32,
  h, x1, the MLP operand and hidden, and the output in bf16). Its bf16
  output stays within `bf16_error_limit` of the plain version, which the
  card holds the CUDA kernel to; padded rows have limit 0."""
  jargs, targs = _both(mixer_inputs(seed=7, t=13, c=64, hid=256), "bfloat16")
  tpu = jax_fmb._pallas_forward(*jargs, causal, 11)
  plain = fused_mixer_block.mixer_block(*targs, causal, 11)
  limit = fused_mixer_block.bf16_error_limit(*targs, causal, 11)
  assert limit.shape == targs[0].shape and not limit[:, 11:].any()
  err = np.abs(_np(tpu) - _np(plain))
  assert (err <= limit.numpy()).all(), float((err / limit.numpy().clip(1e-30)).max())


def test_mixer_block_takes_linear_layout_weights():
  """The model hands the kernel Linear weights transposed (`w.t()`)."""
  args = [torch.from_numpy(a) for a in mixer_inputs(seed=3)]
  w1_view = args[7].t().contiguous().t()
  w2_view = args[9].t().contiguous().t()
  out = fused_mixer_block.mixer_block(
      *args[:7], w1_view, args[8], w2_view, args[10]
  )
  ref = fused_mixer_block.mixer_block(*args)
  torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_mixer_block_rejects_other_devices():
  args = [torch.from_numpy(a).to("meta") for a in mixer_inputs()]
  with pytest.raises(ValueError, match="unsupported device"):
    fused_mixer_block.mixer_block(*args)


# The float32 kernel's limit (chip_smoke.py's MIXER_FP32_TOL): 1e-4 absolute
# and relative against the plain float32 block.
MIXER_FP32_KERNEL_TOL = (1e-4, 1e-4)


def _over_fp32_limit(v, ref):
  rtol, atol = MIXER_FP32_KERNEL_TOL
  return float(((v.float() - ref.float()).abs() / (atol + rtol * ref.abs())).max())


def test_tf32_round_is_cvt_rna():
  """tf32_round keeps 10 mantissa bits, rounding to nearest with ties away
  from zero, as cvt.rna.tf32.f32 does."""
  v = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11),
                    1 + 2**-11 - 2**-23, 0.0])
  assert tma_gemm.tf32_round(v).tolist() == [
      1.0, 1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1.0, 0.0]
  x = torch.randn(1000)
  big = tma_gemm.tf32_round(x)
  assert not (big.view(torch.int32) & 0x1FFF).any()
  assert ((x - big).abs() <= 2.0**-11 * x.abs()).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "b,t,c,hid,valid_len",
    [(3, 13, 16, 64, 11), (2, 9, 64, 256, None), (2, 12, 512, 2048, 10)],
    ids=["small", "c64", "served_widths"],
)
def test_mixer_fp32_split_emulation_within_limit(causal, b, t, c, hid,
                                                 valid_len):
  """The float32 kernel's products, error-compensated TF32 (each operand v =
  tf32(v) + tf32(v - tf32(v)), three TF32 products), emulated in float64:
  within the kernel's limit of the plain float32 block (which
  `test_mixer_block_matches_jax_reference` holds to JAX's), at small widths
  and at the served C = 512, H = 2048; both `fp32_controls` (one TF32
  product; the split without A_small . B_big) are outside the limit."""
  targs = [torch.from_numpy(a)
           for a in mixer_inputs(seed=c, b=b, t=t, c=c, hid=hid)]
  plain = fused_mixer_block.mixer_block_reference(*targs, causal, valid_len)
  emulated = fused_mixer_block.mixer_block_tf32x3(*targs, causal, valid_len)
  assert _over_fp32_limit(emulated, plain) <= 1.0
  controls = fused_mixer_block.fp32_controls(*targs, causal, valid_len)
  assert set(controls) == {"single_tf32", "no_small_a"}
  for key, faulty in controls.items():
    assert _over_fp32_limit(faulty, plain) > 1.0, key
    if valid_len is not None:
      assert not faulty[:, valid_len:].any()


# ------------------------------------------------------------ int8 quantizers


def _quantizer_input(seed, shape, kind):
  """Rows of mixed magnitude; "halves" puts many values exactly on .5 steps
  (so rounding half to even shows) and one row of zeros (the amax floor);
  "midpoints" puts values at amax / 2 and 3 amax / 2^k, amax one per
  leading index (so per row and per frame) among bf16 values k / 128 for
  which 127 / amax rounded twice (PyTorch's `127.0 / amax` is
  reciprocal(amax) * 127) differs from one rounding: there x * (127 / amax)
  lands within a float32 step of a .5, and the double rounding moves the
  result by one int8 step."""
  rng = np.random.RandomState(seed)
  x = rng.randn(*shape).astype(np.float32)
  x *= np.exp(rng.randn(*shape[:-1], 1) * 2).astype(np.float32)
  if kind == "halves":
    x = (rng.randint(-254, 255, shape) / 2.0).astype(np.float32)
    x[..., 0] = 127.0  # amax 127: the scale is 1 and .5 values stay .5
    x[0] = 0.0
  if kind == "midpoints":
    ks = np.array([135, 147, 190, 163, 183, 152])[np.arange(shape[0]) % 6]
    amax = (ks / 128.0).astype(np.float32).reshape((-1,) + (1,) * (len(shape) - 1))
    frac = rng.choice([0.5, 0.75, 0.375, -0.5, 1.0 / 128], shape)
    x = (amax * frac).astype(np.float32)
    x[..., 0] = amax[..., 0]
  return x


QUANTIZERS = {
    "quantize_rows": (
        jax_mm.quantize_rows, mixer_math.quantize_rows, (6, 5, 32)),
    "quantize_weight_cols": (
        jax_mm.quantize_weight_cols, mixer_math.quantize_weight_cols, (48, 20)),
    "quantize_lastdim": (
        jax_corr._quantize_lastdim, corr_tents._quantize_lastdim, (3, 7, 6, 16)),
    # The entry the port calls on grids (and, on the card, queries): the
    # plain version on CPU tensors.
    "quantize_per_position": (
        jax_corr._quantize_lastdim, corr_tents.quantize_per_position,
        (3, 7, 6, 16)),
    "quantize_per_frame": (
        jax_corr.quantize_per_frame, corr_tents.quantize_per_frame,
        (2, 3, 7, 6, 16)),
    "extra_convs_q_rows": (jax_fec._q_rows, fused_extra_convs._q_rows, (6, 5, 72)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "halves", "midpoints"])
@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_quantizer_is_bit_equal_to_jax(name, kind, dtype):
  """Same formulas in the same order and float32 throughout: the int8 values
  and the float32 scales are equal bit for bit (tolerance 0)."""
  jax_fn, torch_fn, shape = QUANTIZERS[name]
  if name in ("quantize_rows", "extra_convs_q_rows"):
    dtype = "float32"  # takes float32 LayerNorm or hidden values only
  (jx,), (tx,) = _both([_quantizer_input(3, shape, kind)], dtype)
  jq, jscale = jax_fn(jx)
  tq, tscale = torch_fn(tx)
  assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
  assert tuple(tscale.shape) == tuple(jscale.shape)
  np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
  np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
  assert int(tq.abs().max()) == 127


# ------------------------------------------------------- int8 corr-tents


# Both sides compute the same exact int32 correlation from bit-equal int8
# values and round it to bf16 at the same point, so they differ by float32
# summation order in the tent stages, which can move a y-stage value across
# a bf16 rounding boundary: one bf16 step of it, 2^-8 relative to the
# largest patch value (|corr| <= 1 here), is the tolerance.
CORR_Q8_TOL = 2.0**-8


def _corr_q8_jax(mode, g, q, cy, cx):
  """The JAX package's function for `mode`, as its dispatch picks it (JAX
  quantizes the per-position grid inline, in every call)."""
  if mode == "prequantized":
    gq, gs = jax_corr.quantize_per_frame(g)
    return jax_corr.corr_tent_patches_prequantized(gq, gs, q, cy, cx, 7)
  return jax_corr.corr_tent_patches(
      g, q, cy, cx, 7, "per_frame" if mode == "per_frame" else True)


def _corr_q8_torch(mode, g, q, cy, cx, entry):
  if mode == "prequantized":
    gq, gs = corr_tents.quantize_per_frame(g)
    fn = (corr_tents.corr_tent_patches_prequantized if entry
          else corr_tents.corr_tent_patches_prequantized_reference)
    return fn(gq, gs, q, cy, cx, 7)
  if mode == "prequantized_per_position":
    gq, gs = corr_tents.quantize_per_position(g)
    fn = (corr_tents.corr_tent_patches_prequantized_per_position if entry
          else corr_tents.corr_tent_patches_prequantized_per_position_reference)
    return fn(gq, gs, q, cy, cx, 7)
  if entry:
    return corr_tents.corr_tent_patches(
        g, q, cy, cx, 7, "per_frame" if mode == "per_frame" else True)
  return corr_tents.corr_tent_patches_quantized_reference(
      g, q, cy, cx, 7, per_frame=mode == "per_frame")


Q8_MODES = ["prequantized", "per_frame", "per_position",
            "prequantized_per_position"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", Q8_MODES)
@pytest.mark.parametrize("shape", CORR_SHAPES, ids=["small", "tall_ragged"])
def test_corr_tents_q8_reference_matches_jax_reference(dtype, mode, shape):
  """The plain int8 versions against `_math_reference_prequantized` and
  `_math_reference_quantized` (what the JAX entries run off the TPU)."""
  (g, q, cy, cx), (tg, tq, tcy, tcx) = _both(corr_inputs(**shape), dtype)
  cy, cx = cy.astype(jnp.float32), cx.astype(jnp.float32)
  ref = _corr_q8_jax(mode, g, q, cy, cx)
  out = _corr_q8_torch(mode, tg, tq, tcy.float(), tcx.float(), entry=False)
  assert out.dtype == torch.float32 and out.shape == ref.shape
  np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=CORR_Q8_TOL)
  # The int8 result is the full-precision one, quantized: |corr| <= 1 and
  # one int8 step of a unit-norm row is about 1/127 per factor.
  full = corr_tents.corr_tent_patches(tg, tq, tcy.float(), tcx.float(), 7)
  assert float((out - full).abs().max()) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", Q8_MODES)
def test_corr_tents_q8_entry_matches_pallas_interpret(dtype, mode,
                                                      interpret_kernels):
  """The entries on CPU tensors against the Pallas kernel in interpret mode
  (`frame_scale` given, `quantized="per_frame"`, `quantized=True`). The
  kernel rounds each bf16 tent product and keeps the y-stage and x-tents in
  float32 where the einsum mirror rounds them to bf16: a few bf16 steps."""
  (g, q, cy, cx), (tg, tq, tcy, tcx) = _both(corr_inputs(**CORR_SHAPES[1]), dtype)
  cy, cx = cy.astype(jnp.float32), cx.astype(jnp.float32)
  if mode == "prequantized":
    gq, gs = jax_corr.quantize_per_frame(g)
    ref = jax_corr._pallas_forward(gq, q, cy, cx, 7, frame_scale=gs)
  else:
    ref = jax_corr._pallas_forward(
        g, q, cy, cx, 7, "per_frame" if mode == "per_frame" else True)
  out = _corr_q8_torch(mode, tg, tq, tcy.float(), tcx.float(), entry=True)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=0,
                             atol=CORR_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_tents_prequantized_equals_inline_per_frame(dtype):
  """Quantizing the grid once and reusing it gives what the inline
  per-frame mode gives, bit for bit. The einsum mirror of the inline mode
  applies the grid scale before the bf16 rounding of the correlation, so it
  rounds another number there and again at the y-stage: up to one bf16 step
  (2^-7 of |corr| <= 1) at each, 2^-6 together."""
  _, (tg, tq, tcy, tcx) = _both(corr_inputs(**CORR_SHAPES[0]), dtype)
  gq, gs = corr_tents.quantize_per_frame(tg)
  assert gq.dtype == torch.int8 and gs.shape == (tg.shape[0],)
  pre = corr_tents.corr_tent_patches_prequantized(gq, gs, tq, tcy, tcx, 7)
  inline = corr_tents.corr_tent_patches(tg, tq, tcy, tcx, 7, "per_frame")
  torch.testing.assert_close(pre, inline, rtol=0, atol=0)
  mirror = corr_tents.corr_tent_patches_quantized_reference(
      tg, tq, tcy, tcx, 7, per_frame=True)
  torch.testing.assert_close(pre, mirror, rtol=0, atol=2.0**-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CORR_SHAPES, ids=["small", "tall_ragged"])
def test_corr_tents_prequantized_per_position_equals_inline(dtype, shape):
  """The per-position grid quantized once (`quantize_per_position`) and
  reused through `corr_tent_patches_prequantized_per_position` gives what
  the inline `quantized=True` mode gives, bit for bit (the model's
  refinement loop takes the first route, once per video), and the JAX
  Pallas kernel's result (interpret mode, which quantizes inline) within
  the float route's bf16 tolerance."""
  (g, q, cy, cx), (tg, tq, tcy, tcx) = _both(corr_inputs(**shape), dtype)
  gq, gs = corr_tents.quantize_per_position(tg)
  assert gq.dtype == torch.int8 and gs.shape == tg.shape[:3]
  hoisted = corr_tents.corr_tent_patches_prequantized_per_position(
      gq, gs, tq, tcy, tcx, 7)
  inline = corr_tents.corr_tent_patches(tg, tq, tcy, tcx, 7, True)
  torch.testing.assert_close(hoisted, inline, rtol=0, atol=0)
  jq, js = jax_corr._quantize_lastdim(g)
  np.testing.assert_array_equal(gq.numpy(), np.asarray(jq))
  np.testing.assert_array_equal(gs.numpy(), np.asarray(js))
  jax_corr.FORCE_INTERPRET = True
  try:
    ref = jax_corr._pallas_forward(g, q, cy.astype(jnp.float32),
                                   cx.astype(jnp.float32), 7, True)
  finally:
    jax_corr.FORCE_INTERPRET = False
  np.testing.assert_allclose(_np(hoisted), _np(ref), rtol=0,
                             atol=CORR_TOL["bfloat16"])


def test_corr_tents_rejects_unknown_quantized_mode():
  tensors = [torch.from_numpy(a) for a in corr_inputs()]
  with pytest.raises(ValueError, match="quantized"):
    corr_tents.corr_tent_patches(*tensors, 7, "per_pixel")
  before = (corr_tents.LAUNCHES_Q8_FRAME, corr_tents.LAUNCHES_Q8_POSITION,
            corr_tents.LAUNCHES_QUANTIZE)
  corr_tents.corr_tent_patches(*tensors, 7, True)
  corr_tents.corr_tent_patches(*tensors, 7, "per_frame")
  corr_tents.corr_tent_patches_prequantized_per_position(
      *corr_tents.quantize_per_position(tensors[0]), *tensors[1:], 7)
  assert before == (corr_tents.LAUNCHES_Q8_FRAME,
                    corr_tents.LAUNCHES_Q8_POSITION,
                    corr_tents.LAUNCHES_QUANTIZE)
  with pytest.raises(ValueError, match="unsupported device"):
    corr_tents.quantize_per_position(tensors[0].to("meta"))
  with pytest.raises(ValueError, match="unsupported device"):
    corr_tents.corr_tent_patches_prequantized_per_position(
        *(t.to("meta") for t in corr_tents.quantize_per_position(tensors[0])),
        *tensors[1:], 7)


# The int8 corr-tents at its edges, one shape for every case (2 frames of
# 9 x 11 x 16, 13 queries: N no multiple of the kernel's 8 queries a block):
# windows off every edge and corner of the grid; random centres; a query row
# and a grid row of zeros (the 1e-8 floor of the scale); and rows of exact
# halves with amax 127 (scale 1), so that quantizing rounds .5 ties to even.
Q8_EDGE_CASES = ["off_every_edge", "ragged_n", "zero_rows", "half_ties"]


def _q8_edge_inputs(case, bt=2, h=9, w=11, c=16, n=13):
  grid, query, cy, cx = corr_inputs(seed=5, bt=bt, h=h, w=w, c=c, n=n)
  if case == "off_every_edge":
    # Centres beyond each edge and corner, and just inside them.
    ys = np.array([-4.6, -1.3, 0.2, 4.5, h - 1.1, h + 0.4, h + 3.8])
    xs = np.array([-5.1, -0.7, 0.4, 5.5, w - 0.9, w + 0.6, w + 4.2])
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    pick = np.random.RandomState(6).permutation(yy.size)[:bt * n]
    cy = yy.ravel()[pick].reshape(bt, n).astype(np.float32)
    cx = xx.ravel()[pick].reshape(bt, n).astype(np.float32)
  elif case == "zero_rows":
    query[1, 4] = 0.0
    grid[0, 3, 5] = 0.0
  elif case == "half_ties":
    rng = np.random.RandomState(7)
    for v in (grid, query):
      v[...] = rng.randint(-254, 255, v.shape) / 2.0
      v[..., 0] = 127.0
  return grid, query, cy, cx


@functools.lru_cache(maxsize=None)
def _q8_edge_refs(mode, dtype):
  """JAX's einsum mirror and the Pallas kernel (interpret mode) on the edge
  cases stacked along BT, as numpy: the quantizers work per frame, grid
  position or query row, so the cases do not mix, and each mode and dtype
  costs one trace of each instead of one a case."""
  arrays = [np.concatenate(parts)
            for parts in zip(*(_q8_edge_inputs(case) for case in Q8_EDGE_CASES))]
  (g, q, cy, cx), _ = _both(arrays, dtype)
  cy, cx = cy.astype(jnp.float32), cx.astype(jnp.float32)
  if mode == "prequantized":
    gq, gs = jax_corr.quantize_per_frame(g)
    mirror = jax_corr._math_reference_prequantized(gq, gs, q, cy, cx, 7)
    grid, operands = gq, dict(frame_scale=gs)
  else:
    mirror = jax_corr._math_reference_quantized(g, q, cy, cx, 7)
    grid, operands = g, dict(quantized=True)
  jax_corr.FORCE_INTERPRET = True
  try:
    ref = jax_corr._pallas_forward(grid, q, cy, cx, 7, **operands)
  finally:
    jax_corr.FORCE_INTERPRET = False
  return _np(mirror), _np(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prequantized", "prequantized_per_position"])
@pytest.mark.parametrize("case", Q8_EDGE_CASES)
def test_corr_tents_q8_edge_cases_match_jax(case, mode, dtype):
  """The two int8 routes of the model (K2: a grid quantized per frame; K2b:
  per position, both once per video) at their edges, against JAX's einsum
  mirror (`_math_reference_prequantized`; `_math_reference_quantized`,
  which quantizes the same grid inline) within one bf16 step of the largest
  patch value, and against the Pallas kernel in interpret mode within the
  float route's bf16 tolerance (it rounds each tent product), both relative
  to the largest patch value (the half-tie rows reach |corr| ~ 1e5)."""
  arrays = _q8_edge_inputs(case)
  (_, q, _, _), (tg, tq, tcy, tcx) = _both(arrays, dtype)
  out = _np(_corr_q8_torch(mode, tg, tq, tcy.float(), tcx.float(), entry=True))
  frames = slice(Q8_EDGE_CASES.index(case) * len(arrays[0]),
                 (Q8_EDGE_CASES.index(case) + 1) * len(arrays[0]))
  mirror, ref = (r[frames] for r in _q8_edge_refs(mode, dtype))
  top = float(np.abs(mirror).max())
  assert top > 0
  np.testing.assert_allclose(out, mirror, rtol=0, atol=CORR_Q8_TOL * top)
  np.testing.assert_allclose(out, ref, rtol=0, atol=CORR_TOL["bfloat16"] * top)
  if case == "zero_rows":
    # A query of zeros quantizes to zeros with the floor's scale: no patch.
    assert not out[1, :, :, 4].any()
    np.testing.assert_array_equal(corr_tents._quantize_lastdim(tq)[1].numpy(),
                                  np.asarray(jax_corr._quantize_lastdim(q)[1]))
  if case == "off_every_edge":
    # Windows wholly off the grid give zero patches on both sides.
    far = np.abs(ref).max(axis=(1, 2)) == 0
    assert far.any() and not out.transpose(0, 3, 1, 2)[far].any()


# ------------------------------------------------------ w8a8 mixer block


def _int8_weights(w1, w2, framework):
  q = jax_mm.quantize_weight_cols if framework == "jax" else (
      mixer_math.quantize_weight_cols)
  return (*q(w1), *q(w2))


# Integer arithmetic is exact on both sides and the int8 weights are bit
# equal, so the outputs differ by float32 noise (LayerNorm sums, tanh), and
# where that noise moves an activation across a rounding boundary, by one
# int8 step of one value: hs * |w2| ~ 0.03 * 0.1 on these inputs, under
# 5e-3. bf16 adds the roundings of x1 and the output (values of O(1)).
MIXER_Q8_TOL = {"float32": 5e-3, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_math_q8_matches_jax(dtype):
  rng = np.random.RandomState(11)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  c, hid = 32, 128
  arrays = [f(40, c), f(c) * 0.2 + 1, f(c, hid) * 0.2, f(hid) * 0.1,
            f(hid, c) * 0.1, f(c) * 0.1]
  (jx, jg, jw1, jb1, jw2, jb2), (tx, tg, tw1, tb1, tw2, tb2) = _both(arrays, dtype)
  jw1q, js1, jw2q, js2 = _int8_weights(jw1, jw2, "jax")
  tw1q, ts1, tw2q, ts2 = _int8_weights(tw1, tw2, "torch")
  np.testing.assert_array_equal(tw1q.numpy(), np.asarray(jw1q))
  ref = jax_mm.mlp_math_q8(jx, jg, jw1q, js1, jb1, jw2q, js2, jb2)
  out = mixer_math.mlp_math_q8(tx, tg, tw1q, ts1, tb1, tw2q, ts2, tb2)
  assert out.dtype == tx.dtype
  tol = MIXER_Q8_TOL[dtype]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
  # Most elements agree to float32 noise: flips are rare.
  if dtype == "float32":
    assert np.mean(np.abs(_np(out) - _np(ref)) > 1e-5) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "t,valid_len", [(10, None), (13, 9)], ids=["t10", "t13_valid9"],
)
def test_mixer_block_q8_matches_jax_reference(dtype, causal, t, valid_len):
  jargs, targs = _both(mixer_inputs(seed=t, t=t), dtype)
  ref = jax_fmb._math_reference(*jargs, causal, valid_len, quantized=True)
  out = fused_mixer_block.mixer_block(*targs, causal, valid_len, quantized=True)
  assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
  tol = MIXER_Q8_TOL[dtype]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
  if valid_len is not None:
    assert not out[:, valid_len:].any()
  # Pre-quantized weights give the same block, bit for bit.
  qweights = _int8_weights(targs[7], targs[9], "torch")
  again = fused_mixer_block.mixer_block(
      *targs[:7], None, targs[8], None, targs[10], causal, valid_len,
      quantized=True, qweights=qweights)
  torch.testing.assert_close(again, out, rtol=0, atol=0)
  # And it is the full-precision block up to quantization noise.
  full = fused_mixer_block.mixer_block(*targs, causal, valid_len)
  assert 0 < float((out.float() - full.float()).abs().max()) < 0.1


@pytest.mark.parametrize("causal", [False, True])
def test_mixer_block_q8_matches_pallas_interpret(causal, interpret_kernels):
  jargs, targs = _both(mixer_inputs(seed=5, t=13), "float32")
  ref = jax_fmb._pallas_forward(*jargs, causal, 11, quantized=True)
  out = fused_mixer_block.mixer_block(*targs, causal, 11, quantized=True)
  tol = MIXER_Q8_TOL["float32"]
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
  assert not out[:, 11:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_q8_limit_covers_tpu_kernel_rounding(dtype, interpret_kernels):
  """The TPU kernel rounds where the CUDA kernel does (LN1 kept in float32,
  the operand and the hidden quantized from float32). Its output stays
  within `q8_error_limit` of the plain version, which the card holds the
  CUDA kernel to; padded rows have limit 0."""
  jargs, targs = _both(mixer_inputs(seed=7, t=13, c=64, hid=256), dtype)
  tpu = jax_fmb._pallas_forward(*jargs, False, 11, quantized=True)
  plain = fused_mixer_block.mixer_block(*targs, False, 11, quantized=True)
  limit, xq, hq = fused_mixer_block.q8_error_limit(*targs, False, 11)
  assert limit.shape == targs[0].shape and not limit[:, 11:].any()
  assert xq.shape == (3 * 11, 64) and hq.shape == (3 * 11, 256)
  err = np.abs(_np(tpu) - _np(plain))
  assert (err <= limit.numpy()).all(), float((err / limit.numpy().clip(1e-30)).max())


def test_int8_matmul_is_exact():
  rng = np.random.RandomState(2)
  a = rng.randint(-127, 128, (9, 2048)).astype(np.int8)
  b = rng.randint(-127, 128, (2048, 7)).astype(np.int8)
  a[0], b[:, 0] = 127, 127  # 2048 * 127^2 is beyond float32's 2^24
  out = mixer_math.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
  assert out.dtype == torch.int32
  np.testing.assert_array_equal(
      out.numpy(), a.astype(np.int64) @ b.astype(np.int64))


# -------------------------------------------------- int8 ExtraConvs pieces


def _jax_conv_weight_q8(w_hwio):
  """The JAX package's int8 conv weights: `_w_scales` and the rounding of
  `_pallas_forward` / `qconv.conv2d_q8_math`."""
  ws = jax_fec._w_scales(w_hwio)
  wq = jnp.clip(jnp.round(w_hwio.astype(jnp.float32) / ws), -127.0, 127.0)
  return wq.astype(jnp.int8), ws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "halves"])
def test_conv_weight_quantizer_is_bit_equal_to_jax(kind, dtype):
  """Per-output-channel scales and int8 values of a conv weight: tolerance
  0. The port's layout is [C_out, kh, kw, C_in]; one output channel is all
  zeros (the 1e-8 floor, as a zero-initialised conv_out)."""
  w = _quantizer_input(5, (3, 3, 16, 24), kind)
  w[..., 3] = 0.0
  (jw,), (tw,) = _both([w], dtype)
  jq, js = _jax_conv_weight_q8(jw)
  tq, ts = qconv.quantize_conv_weight(tw.permute(3, 2, 0, 1))
  assert tq.dtype == torch.int8 and tq.shape == (24, 3, 3, 16) and tq.is_contiguous()
  np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(3, 0, 1, 2))
  np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
  assert not tq[3].any()
  # The layer's HWIO entry quantizes the same way.
  wuq, su, _, _ = fused_extra_convs.quantized_weights(tw, tw.permute(0, 1, 3, 2))
  torch.testing.assert_close(wuq, tq, rtol=0, atol=0)
  torch.testing.assert_close(su, ts, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "halves"])
def test_per_frame_conv_quantizer_is_bit_equal_to_jax(kind, dtype):
  """The activation quantizer of `qconv.conv2d_q8_math` (its lines 54-57,
  one scale per frame over H, W and C): tolerance 0, in any layout."""
  x = _quantizer_input(6, (3, 5, 4, 16), kind)
  (jx,), (tx,) = _both([x], dtype)
  xf = jx.astype(jnp.float32)
  xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True), 1e-8)
  xs = xs * (1.0 / 127.0)
  jq = jnp.clip(jnp.round(xf / xs), -127.0, 127.0).astype(jnp.int8)
  tq, ts = qconv.quantize_per_frame(tx.permute(0, 3, 1, 2))
  np.testing.assert_array_equal(tq.permute(0, 2, 3, 1).numpy(), np.asarray(jq))
  np.testing.assert_array_equal(ts.numpy(), np.asarray(xs).reshape(-1))


def conv_q8_inputs(seed=0, n=3, h=7, w=6, cin=16, cout=24):
  rng = np.random.RandomState(seed)
  x = rng.randn(n, h, w, cin).astype(np.float32)
  x *= np.exp(rng.randn(n, 1, 1, 1)).astype(np.float32)  # frames of other ranges
  k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
  b = (rng.randn(cout) * 0.1).astype(np.float32)
  return x, k, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_q8_matches_jax(dtype):
  """Bit-equal int8 operands and exact integer products on both sides: the
  float32 dequantization `acc * (xs * ws) + b` differs by a contraction into
  a fused multiply-add at most (1e-6 relative); in bf16 that can move the
  output across a rounding boundary, one bf16 step (2^-8 relative)."""
  (jx, jk, jb), (tx, tk, tb) = _both(conv_q8_inputs(), dtype)
  ref = jax_qconv.conv2d_q8_math(jx, jk, jb)
  out = qconv.conv2d_q8(tx.permute(0, 3, 1, 2), tk.permute(3, 2, 0, 1), tb)
  assert out.dtype == tx.dtype and out.shape == (3, 24, 7, 6)
  tol = 1e-6 if dtype == "float32" else 2.0**-8
  np.testing.assert_allclose(_np(out.permute(0, 2, 3, 1)), _np(ref), rtol=tol,
                             atol=tol)
  # Pre-quantized weights give the same output, bit for bit, and the
  # weight is then not read.
  qweights = qconv.quantize_conv_weight(tk.permute(3, 2, 0, 1))
  again = qconv.conv2d_q8(tx.permute(0, 3, 1, 2), None, tb, qweights)
  torch.testing.assert_close(again, out, rtol=0, atol=0)
  # And the full-precision conv, up to quantization noise.
  full = qconv.conv2d_fp_math(tx.permute(0, 3, 1, 2).float(),
                              tk.permute(3, 2, 0, 1), tb)
  err = float((out.float() - full).abs().max())
  assert 0 < err < 0.03 * float(full.abs().max())


def test_conv2d_q8_over_frame_chunks(monkeypatch):
  """The plain version cut into frame chunks (as at the served shapes on the
  card) gives the same output bit for bit: frames are independent."""
  _, (tx, tk, tb) = _both(conv_q8_inputs(seed=1, n=5), "float32")
  args = (tx.permute(0, 3, 1, 2), tk.permute(3, 2, 0, 1), tb)
  whole = qconv.conv2d_q8_math(*args)
  monkeypatch.setattr(qconv, "_CHUNK_ELEMENTS", 1)
  torch.testing.assert_close(qconv.conv2d_q8_math(*args), whole, rtol=0, atol=0)


# (n, h, w, C_in, C_out) for the padded-slab emulation: N = 1-3, H != W,
# W + 2 no divisor of 128, C_in = 16 and 48 (a K step mostly zeros), C_in
# over one K step of 128 channels, C_out over one 256-column tile, and
# single-pixel frames.
SLAB_SHAPES = [(1, 5, 7, 16, 32), (2, 6, 9, 48, 16), (3, 4, 3, 16, 48),
               (2, 1, 1, 48, 32), (1, 3, 13, 160, 272)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,cin,cout", SLAB_SHAPES,
                         ids=["c16", "c48_w9", "n3_c16", "one_pixel",
                              "two_k_steps_ragged_n"])
def test_padded_slab_equals_conv2d_q8(dtype, n, h, w, cin, cout):
  """The CUDA kernel's indexing of X (one GEMM over the zero-ringed frames,
  a shifted row box per tap, K steps of 128 channels) gives the plain
  version's output bit for bit, and JAX's within `test_conv2d_q8_matches_jax`'s
  contraction allowance."""
  (jx, jk, jb), (tx, tk, tb) = _both(
      conv_q8_inputs(seed=n + h, n=n, h=h, w=w, cin=cin, cout=cout), dtype)
  args = (tx.permute(0, 3, 1, 2), tk.permute(3, 2, 0, 1), tb)
  slab = qconv.conv2d_q8_padded_slab(*args)
  plain = qconv.conv2d_q8_math(*args)
  assert slab.shape == plain.shape == (n, cout, h, w)
  torch.testing.assert_close(slab, plain, rtol=0, atol=0)
  ref = jax_qconv.conv2d_q8_math(jx, jk, jb)
  tol = 1e-6 if dtype == "float32" else 2.0**-8
  np.testing.assert_allclose(_np(slab.permute(0, 2, 3, 1)), _np(ref), rtol=tol,
                             atol=tol)


def test_conv2d_q8_rejects_other_devices():
  _, (tx, tk, tb) = _both(conv_q8_inputs(), "float32")
  with pytest.raises(ValueError, match="unsupported device"):
    qconv.conv2d_q8(tx.permute(0, 3, 1, 2).to("meta"), tk.permute(3, 2, 0, 1), tb)


def extra_convs_inputs(seed=0, n=2, h=6, w=5, c=8, mult=4):
  """The inputs of tests/test_fused_extra_convs.py::make_inputs."""
  rng = np.random.RandomState(seed)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  return [
      f(n, h, w, c) * 0.5, f(c) * 0.2 + 1.0, f(c) * 0.1,
      f(3, 3, c, mult * c) * 0.2, f(mult * c) * 0.1,
      f(3, 3, mult * c, c) * 0.1, f(c) * 0.1,
  ]


# The per-pixel layer in fp32 against the JAX reference and the Pallas
# kernel. Integer products are exact and the quantizers bit-equal, so the
# two differ by float32 noise (LayerNorm sums, tanh), and where that noise
# moves a patch or hidden value across an int8 rounding boundary, by one step
# of it: a conv_up step moves a hidden value by cs * su * |wuq| ~ 0.02 *
# 0.005 * 127, through conv_out under 1e-3 of the output; a conv_out step
# moves the output by vs * so * |woq| ~ 1e-3. Outputs are O(1).
EXTRA_CONVS_Q8_TOL = 3e-3
# The float layer (quantized=False): summation order, 1e-5.
EXTRA_CONVS_FP_TOL = 1e-5


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hw", [(6, 5), (5, 5)], ids=["6x5", "5x5"])
def test_extra_convs_layer_matches_jax_reference(quantized, hw):
  h, w = hw
  jargs, targs = _both(extra_convs_inputs(seed=h, h=h, w=w), "float32")
  ref = jax_fec._math_reference(*jargs, quantized)
  out = fused_extra_convs.extra_convs_layer(*targs, quantized)
  assert out.dtype == torch.float32 and out.shape == targs[0].shape
  tol = EXTRA_CONVS_Q8_TOL if quantized else EXTRA_CONVS_FP_TOL
  np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
  if quantized:
    # Most elements agree to float32 noise: steps apart are rare.
    assert np.mean(np.abs(_np(out) - _np(ref)) > 1e-5) < 0.05
    full = fused_extra_convs.extra_convs_layer(*targs, False)
    assert 0 < float((out - full).abs().max()) < 0.1


@pytest.mark.parametrize("hw", [(6, 5), (5, 5)], ids=["6x5", "5x5"])
def test_extra_convs_layer_matches_pallas_interpret(hw, interpret_kernels):
  """The per-pixel layer against the TPU kernel K6 in interpret mode, which
  starts its tap sums from the bias where the reference adds it last; at
  (5, 5) the padded frame's 49 rows are not a multiple of 8."""
  h, w = hw
  jargs, targs = _both(extra_convs_inputs(seed=10 + h, h=h, w=w), "float32")
  ref = jax_fec._pallas_forward(*jargs, True)
  out = fused_extra_convs.extra_convs_layer(*targs, True)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=EXTRA_CONVS_Q8_TOL,
                             atol=EXTRA_CONVS_Q8_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(6, 4), (5, 7)], ids=["even", "odd"])
def test_extra_convs_fp_layer_matches_pallas_interpret(dtype, hw,
                                                      interpret_kernels):
  """The full-precision layer (what K6f computes) against the TPU kernel in
  interpret mode, which masks its pad rows and starts its tap sums from the
  bias: fp32 within EXTRA_CONVS_FP_TOL, bf16 within `fp_error_limit`."""
  h, w = hw
  jargs, targs = _both(extra_convs_inputs(seed=20 + h, n=3, h=h, w=w, c=16),
                       dtype)
  ref = jax_fec._pallas_forward(*jargs, False)
  out = fused_extra_convs.extra_convs_layer(*targs, False)
  assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
  if dtype == "float32":
    np.testing.assert_allclose(_np(out), _np(ref), rtol=EXTRA_CONVS_FP_TOL,
                               atol=EXTRA_CONVS_FP_TOL)
  else:
    limit = fused_extra_convs.fp_error_limit(*targs).numpy()
    err = np.abs(_np(out) - _np(ref))
    assert (err <= limit).all(), float((err / limit).max())


def test_extra_convs_fp_bf16_matches_jax_reference():
  """bf16: the plain layer against `_math_reference(..., False)` within
  `fp_error_limit`: the same roundings (t and the hidden to bf16, the
  residual on t32), summed in other orders."""
  jargs, targs = _both(extra_convs_inputs(seed=4, n=3, h=7, w=6, c=16),
                       "bfloat16")
  ref = jax_fec._math_reference(*jargs, False)
  out = fused_extra_convs.extra_convs_layer(*targs, False)
  limit = fused_extra_convs.fp_error_limit(*targs)
  assert limit.shape == targs[0].shape and limit.dtype == torch.float32
  err = np.abs(_np(out) - _np(ref))
  assert (err <= limit.numpy()).all(), float((err / limit.numpy()).max())


def _served_scale_fp_inputs(seed, n, h, w, c):
  """K6f's inputs scaled as chip_smoke.extra_convs_inputs scales them
  (conv_up's output and the residual O(1)), M = 4C, made with numpy."""
  rng = np.random.RandomState(seed)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  m = 4 * c
  return [f(n, h, w, c), f(c) * 0.2 + 1, f(c) * 0.1, f(3, 3, c, m) / (3 * c**0.5),
          f(m) * 0.1, f(3, 3, m, c) / (6 * m**0.5), f(c) * 0.1]


@pytest.mark.parametrize("control",
                         ["unmasked_pad", "bf16_t_residual", "hidden_precision",
                          "single_tf32", "no_small_a"])
def test_extra_convs_fp_limit_refuses_controls(control):
  """In float32, `fp_error_limit` (1e-4) refuses each faulty plain layer of
  `fp_output_controls` and of `fp32_controls` (one TF32 product; the TF32
  split without A_small . B_big) at the served layer's scale (conv_up's
  output and the residual O(1), as chip_smoke.py scales it), and the plain
  layer itself passes."""
  args = [torch.from_numpy(a) for a in _served_scale_fp_inputs(0, 2, 9, 7, 32)]
  plain = fused_extra_convs.extra_convs_layer(*args, False)
  limit = fused_extra_convs.fp_error_limit(*args)
  controls = (fused_extra_convs.fp32_controls
              if control in ("single_tf32", "no_small_a")
              else fused_extra_convs.fp_output_controls)
  faulty = controls(*args)
  assert float(((faulty[control] - plain).abs() / limit).max()) > 1.0
  ref = fused_extra_convs.extra_convs_layer_reference(*args, False)
  assert float(((ref - plain).abs() / limit).max()) <= 1.0


def test_extra_convs_fp_unfused_limit():
  """bf16: the model's unfused float layer (`layers.ExtraConvs`, bf16
  convolutions) against the plain layer within
  `fp_error_limit(unfused=True)`, which still refuses the plain layer that
  lets the pad ring's hidden through; `fp_error_limit` refuses it too."""
  rng = np.random.RandomState(1)
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
  n, h, w, c, m = 3, 9, 7, 32, 128
  args = [f(n, h, w, c).bfloat16(), f(c) * 0.2 + 1, f(c) * 0.1,
          f(3, 3, c, m) / (3 * c**0.5), f(m) * 0.1,
          f(3, 3, m, c) / (6 * m**0.5), f(c) * 0.1]
  x, g, bln, wu, bu, wo, bo = args
  model = layers.ExtraConvs(channels=c, num_layers=1, channel_multiplier=m // c)
  model.load_state_dict({
      "ln_0.scale": g, "ln_0.bias": bln,
      "conv_up_0.weight": wu.permute(3, 2, 0, 1), "conv_up_0.bias": bu,
      "conv_out_0.weight": wo.permute(3, 2, 0, 1), "conv_out_0.bias": bo})
  with torch.no_grad():
    unfused = model.to(torch.bfloat16)(x.permute(0, 3, 1, 2))
  unfused = unfused.permute(0, 2, 3, 1).float()
  plain = fused_extra_convs.extra_convs_layer(*args, False).float()
  limit = fused_extra_convs.fp_error_limit(*args, unfused=True)
  assert float(((plain - unfused).abs() / limit).max()) <= 1.0
  faulty = fused_extra_convs.fp_output_controls(*args)["unmasked_pad"].float()
  assert float(((faulty - unfused).abs() / limit).max()) > 1.0
  fused_limit = fused_extra_convs.fp_error_limit(*args)
  assert float(((faulty - plain).abs() / fused_limit).max()) > 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c", [(2, 6, 5, 16), (1, 3, 7, 48),
                                     (2, 1, 1, 16), (1, 5, 4, 80)],
                         ids=["c16", "c48_two_k_steps", "one_pixel",
                              "c80_ragged_k"])
def test_fp_padded_slab_equals_plain_layer(dtype, n, h, w, c):
  """The bf16 kernel's formulation of K6f (t and the hidden in zero-ringed
  frames, each product one GEMM over the padded rows with a shifted row box
  per tap and K steps of 64 bf16 values), emulated in float64 products,
  against the plain layer and the JAX reference within `fp_error_limit`
  (the limit the card holds K6f to: fp32 1e-4 absolute and relative, since
  at C = 80 the float32 sums of 720 products in other orders already differ
  by 2e-5); the padded hidden's ring is zero. A card failure of K6f that
  this passes is the kernel's, not the indexing's."""
  jargs, targs = _both(extra_convs_inputs(seed=30 + c, n=n, h=h, w=w, c=c),
                       dtype)
  slab, hidden = fused_extra_convs.fp_padded_slab(*targs)
  plain = fused_extra_convs.extra_convs_layer_reference(*targs, False)
  ref = jax_fec._math_reference(*jargs, False)
  assert slab.shape == plain.shape and slab.dtype == plain.dtype
  assert hidden.shape == (n, h + 2, w + 2, 4 * c)
  ring = torch.ones(n, h + 2, w + 2, dtype=torch.bool)
  ring[:, 1:h + 1, 1:w + 1] = False
  assert not hidden[ring].any()
  limit = fused_extra_convs.fp_error_limit(*targs).numpy()
  for other in (plain, ref):
    err = np.abs(_np(slab) - _np(other))
    assert (err <= limit).all(), float((err / limit).max())


@pytest.mark.parametrize("n,h,w,c", [(2, 6, 5, 256), (1, 3, 7, 48),
                                     (2, 1, 1, 16), (1, 5, 4, 80)],
                         ids=["served_widths", "c48_two_k_steps", "one_pixel",
                              "c80_ragged_k"])
def test_extra_convs_fp32_split_emulation_within_limit(n, h, w, c):
  """The float32 kernel's formulation of K6f (the padded slabs, K steps of
  32 float32 values, each product as three TF32 products of the operands'
  big and small parts), emulated in float64 (`fp_padded_slab(terms=
  "tf32x3")`), within `fp_error_limit`'s 1e-4 of the plain layer and of the
  JAX reference, at the served widths C = 256, M = 1024 (conv_out's K of
  9216) and at the edges; the padded hidden's ring is zero. At the served
  widths both `fp32_controls` are refused by the same limit."""
  inputs = _served_scale_fp_inputs(40 + c, n, h, w, c)
  jargs, targs = _both(inputs, "float32")
  emulated, hidden = fused_extra_convs.fp_padded_slab(*targs, terms="tf32x3")
  plain = fused_extra_convs.extra_convs_layer_reference(*targs, False)
  ref = jax_fec._math_reference(*jargs, False)
  limit = fused_extra_convs.fp_error_limit(*targs)
  assert emulated.shape == plain.shape and emulated.dtype == torch.float32
  ring = torch.ones(n, h + 2, w + 2, dtype=torch.bool)
  ring[:, 1:h + 1, 1:w + 1] = False
  assert not hidden[ring].any()
  for other in (plain, ref):
    over = float((np.abs(_np(emulated) - _np(other)) / limit.numpy()).max())
    assert over <= 1.0, over
  if c == 256:
    for key, faulty in fused_extra_convs.fp32_controls(*targs).items():
      assert float(((faulty - plain).abs() / limit).max()) > 1.0, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extra_convs_layer_pieces(dtype, monkeypatch):
  """Pre-quantized weights and frame chunks give the same layer bit for
  bit; bf16 input stays float32 inside and is cast once at the end."""
  _, targs = _both(extra_convs_inputs(seed=3, n=3), dtype)
  out = fused_extra_convs.extra_convs_layer(*targs, True)
  assert out.dtype == targs[0].dtype
  qweights = fused_extra_convs.quantized_weights(targs[3], targs[5])
  again = fused_extra_convs.extra_convs_layer(
      targs[0], targs[1], targs[2], None, targs[4], None, targs[6], True,
      qweights=qweights)
  torch.testing.assert_close(again, out, rtol=0, atol=0)
  monkeypatch.setattr(qconv, "_CHUNK_ELEMENTS", 1)
  chunked = fused_extra_convs.extra_convs_layer(*targs, True)
  torch.testing.assert_close(chunked, out, rtol=0, atol=0)


def test_wants_fused_is_the_jax_gate():
  for shape in [(16, 32, 32, 256), (15, 32, 32, 256), (24, 32, 32, 256),
                (250, 60, 60, 256), (64, 32, 32, 96), (4, 1024, 1024)]:
    x = np.zeros(shape, np.float32)
    for per_pixel in (False, True):
      assert fused_extra_convs.wants_fused(torch.from_numpy(x), per_pixel) == (
          jax_fec.wants_fused(jnp.asarray(x), per_pixel)), (shape, per_pixel)


def test_extra_convs_layer_cpu_does_not_launch_and_rejects_other_devices():
  _, targs = _both(extra_convs_inputs(), "float32")
  counts = lambda: (fused_extra_convs.LAUNCHES, fused_extra_convs.LAUNCHES_FP,
                    qconv.LAUNCHES_Q8)
  before = counts()
  fused_extra_convs.extra_convs_layer(*targs, True)
  fused_extra_convs.extra_convs_layer(*targs, False)
  assert counts() == before
  with pytest.raises(ValueError, match="unsupported device"):
    fused_extra_convs.extra_convs_layer(targs[0].to("meta"), *targs[1:], True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extra_convs_q8_limit_covers_tpu_kernel(dtype, interpret_kernels):
  """K6 on the TPU (interpret mode) rounds where the CUDA kernel does (t32
  and the hidden in float32, the tap sums from the bias): its output stays
  within `q8_error_limit` of the plain version, which the card holds the CUDA
  kernel to."""
  jargs, targs = _both(extra_convs_inputs(seed=8, n=3, h=7, w=6, c=16), dtype)
  tpu = jax_fec._pallas_forward(*jargs, True)
  x, g, bln, wu, bu, wo, bo = targs
  qweights = fused_extra_convs.quantized_weights(wu, wo)
  limit, hq = fused_extra_convs.q8_error_limit(x, g, bln, bu, bo, qweights)
  assert limit.shape == x.shape and hq.shape == (3 * 7 * 6, 64)
  plain = fused_extra_convs.extra_convs_layer(x, g, bln, wu, bu, wo, bo, True)
  err = np.abs(_np(tpu) - _np(plain))
  assert (err <= limit.numpy()).all(), float((err / limit.numpy()).max())


@pytest.mark.parametrize("control", ["bf16_t32_residual", "output_pixel_scale"])
def test_extra_convs_q8_limit_refuses_controls(control):
  """In float32, `q8_error_limit` refuses the plain layer with a fault the
  card's check must catch: t32 rounded to bf16 before the residual (up to
  2^-8 |t32|), or each conv_out tap dequantized with the output pixel's
  scale. The weights are scaled as chip_smoke.py scales the served layer
  (conv_up's output and the residual O(1)), where the int8 noise that the
  limit allows is below t32's bf16 step; measured 1.7 and 76 times the
  limit here."""
  rng = np.random.RandomState(0)
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
  n, h, w, c, m = 4, 16, 16, 32, 128
  x, g, bln = f(n, h, w, c), f(c) * 0.2 + 1, f(c) * 0.1
  wu, bu = f(3, 3, c, m) / (3 * c**0.5), f(m) * 0.1
  wo, bo = f(3, 3, m, c) / (6 * m**0.5), f(c) * 0.1
  qweights = fused_extra_convs.quantized_weights(wu, wo)
  limit, _ = fused_extra_convs.q8_error_limit(x, g, bln, bu, bo, qweights)
  plain = fused_extra_convs.extra_convs_layer(x, g, bln, wu, bu, wo, bo, True)
  faulty = fused_extra_convs.q8_output_controls(x, g, bln, bu, bo, qweights)
  assert float(((faulty[control] - plain).abs() / limit).max()) > 1.0
