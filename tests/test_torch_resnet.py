"""PyTorch port, the generic ResNet (models/resnet.py) against the JAX
package's Flax ResNet: v1 and v2 blocks, plain and bottleneck, with and
without the stem max-pool, under each normalization (instance, layer,
batch, none), at narrow widths on an even and an odd frame size; BatchNorm
also in training mode, with its updated running statistics.

Both sides run in float64 (`jax.enable_x64`; InstanceNorm keeps its float32
statistics in both packages): in float32 the few values of the deepest maps
carry summation-order noise to 6.6e-6 of the output's largest value, within
1.5x of the 1e-5 limit, where float64 leaves only InstanceNorm's float32
rounding.
"""

import itertools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.models import resnet as jax_resnet  # noqa: E402
from tapnet_tpu_torch.checkpoints.convert import load_resnet_params  # noqa: E402
from tapnet_tpu_torch.models import resnet  # noqa: E402

NARROW = dict(blocks_per_group=(1, 1, 1, 1), channels_per_group=(8, 8, 16, 16),
              stem_channels=8, use_projection=(True, True, True, False))
# Even sizes (XLA's SAME pads a stride-2 window after the frame only) and odd
# ones (on both sides).
SIZES = {"even": (40, 48), "odd": (37, 45)}
FRAMES = 3
# Of the largest |value| of each output (float64; see the docstring).
TOL = 1e-5
STATS_TOL = 1e-6
GRID = list(itertools.product(
    (True, False), ("instancenorm", "layernorm", "batchnorm", None),
    (False, True), (False, True)))


def _ids(case):
  v2, norm, bottleneck, pool = case
  return "-".join([("v2" if v2 else "v1"), str(norm).lower(),
                   ("bottleneck" if bottleneck else "plain"),
                   ("maxpool" if pool else "nopool")])


def _frames(size, seed):
  return np.random.RandomState(seed).randn(FRAMES, *size, 3)


def _jax_model(v2, norm, bottleneck, pool):
  cfg = jax_resnet.ResNetConfig(resnet_v2=v2, normalization=norm,
                                bottleneck=bottleneck, use_max_pool=pool,
                                **NARROW)
  return jax_resnet.ResNet(config=cfg), resnet.ResNetConfig(
      resnet_v2=v2, normalization=norm, bottleneck=bottleneck,
      use_max_pool=pool, **NARROW)


def _variables(model, x, seed):
  """Flax's init with its parameters (and running statistics) moved off
  their initial values, so each norm's scale, bias and statistics act."""
  variables = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x)))
  noise = np.random.RandomState(seed + 1)
  params = jax.tree_util.tree_map(
      lambda v: np.asarray(v) + 0.1 * noise.randn(*v.shape).astype(np.float32),
      variables["params"])
  stats = jax.tree_util.tree_map(
      lambda v: np.asarray(v) + 0.2 * noise.rand(*v.shape).astype(np.float32),
      variables.get("batch_stats", {}))
  return params, stats


def _port(cfg, params, stats):
  model = resnet.ResNet(cfg)
  load_resnet_params(model, params, stats)
  return model.double()


def _nchw(x):
  return torch.from_numpy(x).permute(0, 3, 1, 2)


def _check(ours, theirs, tol):
  """Each group's output within `tol` of the largest |value| of Flax's."""
  assert set(ours) == set(theirs)
  for key, ref in theirs.items():
    got = ours[key].permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype, key
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=key)


@pytest.mark.parametrize("case", GRID, ids=[_ids(c) for c in GRID])
@jax.enable_x64(True)
def test_resnet_matches_flax(case):
  jmodel, cfg = _jax_model(*case)
  x0 = _frames(SIZES["even"], 0)
  params, stats = _variables(jmodel, x0, 3)
  variables = {"params": params}
  if stats:
    variables["batch_stats"] = stats
  model = _port(cfg, params, stats)
  for name, size in SIZES.items():
    x = _frames(size, 1 if name == "even" else 2)
    ref = jax.device_get(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
      _check(model(_nchw(x)), ref, TOL)


@pytest.mark.parametrize("v2", [True, False], ids=["v2", "v1"])
@jax.enable_x64(True)
def test_batchnorm_training_updates_stats_as_flax(v2):
  """In training mode BatchNorm normalizes by the batch and moves its
  running statistics (momentum 0.9, biased variance) as Flax does."""
  jmodel, cfg = _jax_model(v2, "batchnorm", True, True)
  x = _frames(SIZES["odd"], 4)
  params, stats = _variables(jmodel, x, 5)
  ref, updates = jmodel.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), is_training=True,
                              mutable=["batch_stats"])
  model = _port(cfg, params, stats)
  with torch.no_grad():
    out = model(_nchw(x), is_training=True)
  _check(out, jax.device_get(ref), TOL)
  new_stats = {".".join(path): leaf for path, leaf in _flat(
      jax.device_get(updates["batch_stats"]))}
  buffers = dict(model.named_buffers())
  assert set(new_stats) == set(buffers)
  for name, ref_stat in new_stats.items():
    np.testing.assert_allclose(buffers[name].numpy(), ref_stat, rtol=0,
                               atol=STATS_TOL, err_msg=name)
    # The statistics moved: this is not the loaded value.
    assert not np.allclose(ref_stat, _leaf(stats, name.split(".")))


def _flat(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, dict):
      yield from _flat(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def _leaf(tree, path):
  for key in path:
    tree = tree[key]
  return tree


def test_max_pool_pads_as_xla_same():
  """The SAME max-pool picks XLA's windows (nothing before an even size):
  symmetric padding would take the first row and column in the first
  window."""
  x = np.random.RandomState(6).randn(2, 6, 7, 3).astype(np.float32)
  ref = jax.device_get(flax.linen.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                           "SAME"))
  got = resnet.max_pool_same(_nchw(x)).permute(0, 2, 3, 1).numpy()
  np.testing.assert_array_equal(got, ref)


def test_tapir_backbone_is_unchanged():
  """TAPIR's configuration keeps the v2 InstanceNorm blocks and their
  parameter names."""
  model = resnet.ResNet(resnet.ResNetConfig())
  names = {n for n, _ in model.named_parameters()}
  assert "group_0_block_0.norm_0.scale" in names
  assert "group_1_block_0.proj_conv.weight" in names
  assert not any("stem_norm" in n or "proj_norm" in n or "conv_2" in n
                 for n in names)
  with pytest.raises(ValueError, match="normalization"):
    resnet.ResNetConfig(normalization="groupnorm")
