"""PyTorch port, the RG-LRU linear scan (ops/scan.py): the plain version
against the JAX package's `linear_scan`, through its Pallas kernel in
interpret mode and through its associative scan (`_scan_xla`), and the
faulty plain versions that the card's bit-equality check must refuse.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tapnet_tpu.ops import scan as jax_scan
from tapnet_tpu_torch.ops import scan

SHAPES = [(2, 8, 16), (3, 12, 130), (1, 48, 512)]
# fp32: both sides sum in float32 in another order (the associative scan) or
# with other contractions; 1e-5 as tests/test_scan_kernel.py. bf16 I/O: the
# JAX package's bf16 tolerance (tests/test_scan_kernel.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def force_interpret():
  jax_scan.FORCE_INTERPRET = True
  yield
  jax_scan.FORCE_INTERPRET = False


def _inputs(shape, dtype, seed=0, zero_h0=False):
  b, t, c = shape
  rng = np.random.RandomState(seed)
  x = rng.randn(b, t, c).astype(np.float32)
  a = (rng.rand(b, t, c) * 0.25 + 0.7).astype(np.float32)
  h0 = np.zeros((b, c), np.float32) if zero_h0 else rng.randn(b, c).astype(np.float32)
  tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
  xt, at = torch.from_numpy(x).to(tdt), torch.from_numpy(a).to(tdt)
  # JAX gets the same (already rounded) values.
  jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
  xj = jnp.asarray(xt.float().numpy()).astype(jdt)
  aj = jnp.asarray(at.float().numpy()).astype(jdt)
  return (xt, at, torch.from_numpy(h0)), (xj, aj, jnp.asarray(h0))


def _close(port, ref, dtype):
  y, h = port
  ry, rh = ref
  assert y.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
  assert h.dtype == torch.float32
  tol = TOL[dtype]
  np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                             rtol=tol, atol=tol)
  np.testing.assert_allclose(h.numpy(), np.asarray(rh, np.float32),
                             rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_matches_pallas_kernel(force_interpret, shape, dtype):
  port_in, jax_in = _inputs(shape, dtype)
  _close(scan.linear_scan(*port_in), jax_scan.linear_scan(*jax_in), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_matches_associative_scan(shape, dtype):
  port_in, jax_in = _inputs(shape, dtype, seed=1)
  _close(scan.linear_scan(*port_in), jax_scan._scan_xla(*jax_in), dtype)  # pylint: disable=protected-access


def test_fresh_sequence_zero_state(force_interpret):
  port_in, jax_in = _inputs((2, 8, 16), "float32", seed=2, zero_h0=True)
  _close(scan.linear_scan(*port_in), jax_scan.linear_scan(*jax_in), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_step_takes_the_formula(dtype):
  port_in, jax_in = _inputs((3, 1, 130), dtype, seed=3)
  before = scan.LAUNCHES
  y, h = scan.linear_scan(*port_in)
  assert scan.LAUNCHES == before
  _close((y, h), jax_scan.linear_scan(*jax_in), dtype)
  x, a, h0 = port_in
  expected = a[:, 0].float() * h0 + x[:, 0].float()
  assert torch.equal(h, expected)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_mirrors_the_kernel_body(dtype):
  """The plain version makes the TPU kernel's roundings: float32 carry, one
  multiply and one add per step, y rounded to x's dtype once."""
  (x, a, h0), _ = _inputs((3, 12, 130), dtype, seed=4)
  y, h_last = scan.linear_scan_reference(x, a, h0)
  h = h0.clone()
  for t in range(x.shape[1]):
    h = torch.add(torch.mul(a[:, t].float(), h), x[:, t].float())
    assert torch.equal(y[:, t], h.to(x.dtype))
  assert torch.equal(h_last, h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_controls_differ_from_plain(dtype):
  """Each faulty plain version moves some values of (y, h_last) off the
  plain version's bits, so a bit-equality check refuses it."""
  (x, a, h0), _ = _inputs((3, 50, 130), dtype, seed=5)
  y, h_last = scan.linear_scan_reference(x, a, h0)
  for name, (fy, fh) in scan.scan_controls(x, a, h0).items():
    assert fy.shape == y.shape and fy.dtype == y.dtype, name
    assert fh.dtype == torch.float32, name
    assert not (torch.equal(fy, y) and torch.equal(fh, h_last)), name


def test_unsupported_device_raises():
  x = torch.zeros(1, 2, 4, device="meta")
  with pytest.raises(ValueError, match="unsupported device"):
    scan.linear_scan(x, x, torch.zeros(1, 4, device="meta"))
