"""PyTorch port, host-side pieces against the JAX package: coordinate
transforms, bilinear sampling and soft-argmax, the resolution ladder, the
TAPIR configs and the copied checkpoint renaming. fp32, exact up to float
summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu.checkpoints import tapir_checkpoint as jax_ckpt
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu.utils import sampling as jax_sampling
from tapnet_tpu.utils import transforms as jax_transforms
from tapnet_tpu_torch.checkpoints import tapir_checkpoint
from tapnet_tpu_torch.models import tapir
from tapnet_tpu_torch.utils import sampling, transforms

TOL = 1e-5


def _close(ours, theirs, tol=TOL):
  np.testing.assert_allclose(
      ours.numpy(), np.asarray(theirs), rtol=tol, atol=tol
  )


@pytest.mark.parametrize(
    "fmt,src,dst", [("xy", (64, 48), (256, 320)), ("tyx", (5, 48, 64), (5, 30, 20))]
)
def test_convert_grid_coordinates(fmt, src, dst):
  coords = np.random.RandomState(0).rand(3, 4, len(src)).astype(np.float32) * 50
  ours = transforms.convert_grid_coordinates(torch.from_numpy(coords), src, dst, fmt)
  theirs = jax_transforms.convert_grid_coordinates(jnp.asarray(coords), src, dst, fmt)
  _close(ours, theirs)


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_sample_grid_2d_and_3d(mode):
  rng = np.random.RandomState(1)
  grid2 = rng.randn(7, 9, 4).astype(np.float32)
  pts2 = (rng.rand(5, 3, 2) * 12 - 1.5).astype(np.float32)  # some outside
  _close(
      sampling.sample_grid_2d(torch.from_numpy(grid2), torch.from_numpy(pts2), mode),
      jax_sampling.sample_grid_2d(jnp.asarray(grid2), jnp.asarray(pts2), mode),
  )
  grid3 = rng.randn(2, 3, 7, 9, 4).astype(np.float32)
  pts3 = np.concatenate(
      [rng.rand(2, 6, 1) * 3, rng.rand(2, 6, 2) * 10 - 1], -1
  ).astype(np.float32)
  _close(
      sampling.sample_grid_batched(torch.from_numpy(grid3), torch.from_numpy(pts3), mode),
      jax_sampling.sample_grid_batched(jnp.asarray(grid3), jnp.asarray(pts3), mode),
  )


def test_heatmaps_to_points_with_queries():
  rng = np.random.RandomState(2)
  b, n, t, h, w = 1, 3, 4, 8, 10
  logits = rng.randn(b, n, t, h * w).astype(np.float32) * 3
  heat = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
  heat = heat.reshape(b, n, t, h, w)
  im_shape = (b, t, 64, 80, 3)
  qp = np.stack(
      [rng.randint(0, t, n), rng.rand(n) * 64, rng.rand(n) * 80], -1
  )[None].astype(np.float32)
  ours = sampling.heatmaps_to_points(
      torch.from_numpy(heat), im_shape, query_points=torch.from_numpy(qp)
  )
  theirs = jax_sampling.heatmaps_to_points(
      jnp.asarray(heat), im_shape, query_points=jnp.asarray(qp)
  )
  _close(ours, theirs, 1e-4)


def test_postprocess_and_preprocess():
  rng = np.random.RandomState(3)
  occ, expd = rng.randn(2, 4, 6).astype(np.float32) * 2
  np.testing.assert_array_equal(
      sampling.postprocess_occlusions(torch.from_numpy(occ), torch.from_numpy(expd)).numpy(),
      np.asarray(jax_sampling.postprocess_occlusions(jnp.asarray(occ), jnp.asarray(expd))),
  )
  frames = rng.randint(0, 256, (1, 2, 4, 4, 3)).astype(np.uint8)
  _close(
      sampling.preprocess_frames(torch.from_numpy(frames)),
      jax_sampling.preprocess_frames(jnp.asarray(frames)),
  )


@pytest.mark.parametrize(
    "full", [(256, 256), (480, 480), (720, 1280), (128, 96)]
)
def test_default_resolutions(full):
  assert sampling.generate_default_resolutions(full, (256, 256)) == (
      jax_sampling.generate_default_resolutions(full, (256, 256))
  )


@pytest.mark.parametrize("name", ["tapir_config", "bootstapir_config"])
def test_configs_match(name):
  ours = dataclasses.asdict(getattr(tapir, name)())
  theirs = dataclasses.asdict(getattr(jax_tapir, name)())
  for key, value in ours.items():
    assert tuple(np.atleast_1d(value)) == tuple(np.atleast_1d(theirs[key])), key


def test_haiku_renaming_copy_matches():
  rng = np.random.RandomState(4)
  hk = {
      "tapir/~/resnet/~/initial_conv": {"w": rng.randn(7, 7, 3, 8)},
      "tapir/~/resnet/~/block_group_1/~/block_0/~/conv_0": {"w": rng.randn(3, 3, 8, 8)},
      "tapir/~/resnet/~/block_group_1/~/block_0/~/instancenorm_0": {
          "scale": rng.randn(8), "offset": rng.randn(8)},
      "tapir/~/cost_volume_regression_1": {"w": rng.randn(3, 3, 1, 16), "b": rng.randn(16)},
      "tapir/~/pips_mlp_mixer/~/block_2/~/mlp1_up_1": {"w": rng.randn(3, 1, 32), "b": rng.randn(32)},
      "tapir/~/pips_mlp_mixer/~/layer_norm": {"scale": rng.randn(8)},
      "tapir/~/extra_convs/~/conv2_d_3": {"w": rng.randn(3, 3, 8, 4), "b": rng.randn(4)},
  }
  ours = tapir_checkpoint.convert_haiku_tapir_params(hk)
  theirs = jax_ckpt.convert_haiku_tapir_params(hk)

  def flat(tree, prefix=""):
    for k, v in tree.items():
      if isinstance(v, dict):
        yield from flat(v, prefix + k + "/")
      else:
        yield prefix + k, v

  a, b = dict(flat(ours)), dict(flat(theirs))
  assert a.keys() == b.keys()
  for k in a:
    np.testing.assert_array_equal(a[k], b[k])
