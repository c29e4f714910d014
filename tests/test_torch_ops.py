"""PyTorch port, kernel modules: the plain versions of corr_tent_patches and
mixer_block (what the wrappers run on CPU tensors) against the JAX package's
references and its Pallas kernels in interpret mode, fp32 and bf16.

Inputs are made with numpy from a seed and handed to both frameworks; bf16
inputs are rounded once (round-to-nearest-even in both) from the same fp32
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu.ops import corr_tents as jax_corr
from tapnet_tpu.ops import fused_mixer_block as jax_fmb
from tapnet_tpu_torch.ops import corr_tents, fused_mixer_block


@pytest.fixture
def interpret_kernels():
  jax_corr.FORCE_INTERPRET = True
  jax_fmb.FORCE_INTERPRET = True
  yield
  jax_corr.FORCE_INTERPRET = False
  jax_fmb.FORCE_INTERPRET = False


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
