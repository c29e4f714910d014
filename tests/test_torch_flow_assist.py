"""PyTorch port, flow-assisted track annotation against the JAX package
(`utils/flow_track_assist.py`): the forward DP (argmins equal, final cost
within FLOW_COST_RTOL relative) on the flows of tests/test_flow_assist.py
and random ones, with the offset window cut into several blocks; the tracks
of `interpolate_track`; `chain_flow`; the block fold's first-index rule
on exact ties. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.utils import flow_track_assist as jax_fta
from tapnet_tpu_torch.utils import flow_track_assist as fta

# float32 on both sides; XLA may round a candidate's penalty another way
# (a fused multiply-add), which moves the accumulated cost by ulps.
FLOW_COST_RTOL = 1e-6
CHAIN_TOL = 1e-6


def _constant_flow(t, h, w, dx, dy):
  f = np.zeros((t, h, w, 2), np.float32)
  f[..., 0] = dx
  f[..., 1] = dy
  return f


def _noisy_flow():
  rng = np.random.RandomState(0)
  flows = _constant_flow(5, 20, 20, 1.0, 0.0)
  return flows + rng.uniform(-0.3, 0.3, flows.shape).astype(np.float32)


def _subpixel_flow():
  flows = np.zeros((1, 8, 8, 2), np.float32)
  flows[0, :, :, 0] = np.arange(8)[None, :]
  return flows


# tests/test_flow_assist.py's five cases: (flows, start, end, radius).
CASES = {
    "constant_line": (_constant_flow(10, 32, 32, 1.0, 0.5), (4, 4), (14, 9), 3),
    "subpixel": (_subpixel_flow(), (2, 3), (5, 3), 2),
    "constant_motion": (_constant_flow(6, 24, 24, 2.0, 1.0), (2, 3), (14, 9), 4),
    "noisy": (_noisy_flow(), (3, 10), (8, 10), 3),
    "detour": (_constant_flow(4, 16, 16, 1.0, 1.0), (2, 2), (6, 6), 3),
    "random": ((np.random.RandomState(1).randn(4, 19, 23, 2) * 2.5)
               .astype(np.float32), (5, 7), (11, 12), 5),
}


def _init(flows, start):
  h, w = flows.shape[1:3]
  init = np.full((h, w), fta._BIG, np.float32)  # pylint: disable=protected-access
  init[start[1], start[0]] = 0.0
  return init


@pytest.mark.parametrize("name", sorted(CASES))
def test_dp_forward_matches_jax(name, monkeypatch):
  flows, start, end, radius = CASES[name]
  init = _init(flows, start)
  want_cost, want_arg = (np.asarray(x) for x in jax_fta._dp_forward(  # pylint: disable=protected-access
      jnp.asarray(flows), jnp.asarray(init), radius))
  h, w = flows.shape[1:3]
  window = 2 * radius + 1
  # Blocks of two offset rows: the fold across blocks must keep the first
  # offset of the smallest cost, as the JAX loop does.
  monkeypatch.setattr(fta, "_MAX_BLOCK_ELEMENTS", 2 * window * h * w)
  cost, arg = fta._dp_forward(torch.from_numpy(flows),  # pylint: disable=protected-access
                              torch.from_numpy(init), radius)
  np.testing.assert_array_equal(arg.numpy(), want_arg)
  np.testing.assert_allclose(cost.numpy(), want_cost, rtol=FLOW_COST_RTOL,
                             atol=0)
  track = fta.interpolate_track(flows, start, end, radius, device="cpu")
  np.testing.assert_array_equal(
      track, jax_fta.interpolate_track(flows, start, end, radius))


def test_constant_motion_track_follows_flow():
  flows, start, end, radius = CASES["constant_motion"]
  track = fta.interpolate_track(flows, start, end, radius, device="cpu")
  assert track.shape == (7, 2)
  for t in range(7):
    np.testing.assert_allclose(track[t], (2 + 2 * t, 3 + t), atol=1e-5)


def test_exact_ties_take_the_first_offset(monkeypatch):
  """A flow of half a pixel in x and y over a flat cost: the four offsets
  (-1 or 0, -1 or 0) tie exactly, two rows apart in pairs; both the
  one-block and the row-by-row fold keep the first in raster order, as the
  JAX loop does."""
  flows = np.full((2, 9, 9, 2), 0.5, np.float32)
  init = np.full((9, 9), 1.0, np.float32)
  want = np.asarray(jax_fta._dp_forward(jnp.asarray(flows),  # pylint: disable=protected-access
                                        jnp.asarray(init), 2)[1])
  for block in (1 << 26, 5 * 81):
    monkeypatch.setattr(fta, "_MAX_BLOCK_ELEMENTS", block)
    _, arg = fta._dp_forward(torch.from_numpy(flows), torch.from_numpy(init), 2)  # pylint: disable=protected-access
    np.testing.assert_array_equal(arg.numpy(), want)
    assert (arg.numpy()[0, 2:-2, 2:-2] == 1 * 5 + 1).all()


@pytest.mark.parametrize("name", ["constant_line", "subpixel", "random"])
def test_chain_flow_matches_jax(name):
  flows, start, _, _ = CASES[name]
  start = (start[0] + 0.5, start[1] + 0.25)
  np.testing.assert_allclose(fta.chain_flow(flows, start),
                             jax_fta.chain_flow(flows, start),
                             rtol=CHAIN_TOL, atol=CHAIN_TOL)
