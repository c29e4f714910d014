"""PyTorch port, RoboTAP against the JAX package (`robotap/clustering.py`,
`robotap/dense_tracking.py`).

Clustering, piece by piece on the same parameters and draws (JAX's own
`jax.random` draws exported as numpy: permutations, out-of-bounds noise,
surgery noise): the projection matrices in both DoF modes and their
gradient with its +-100 clip, `project`, the point and frame features over
two sequence segments, `get_err`, `assignment_loss` (hard and EM),
`_splice` / `_drop`, `loss_fn` and its gradient in split and in delete
mode, one optimizer update with its `lr_mul`, both surgeries. Values within
VALUE_RTOL relative, gradients within GRAD_TOL of each leaf's largest
value. End to end, tests/test_robotap.py's two cases on the port, whose
classes equal JAX's as a partition on the two-rigid-groups case.

Dense tracking: `track_many_points` at tests/test_robotap.py's tiny causal
config against JAX's (the same video, converted weights and seed), and the
trained causal BootsTAPIR on the CPU against
tests/data/bootstapir_golden_dense.npz (tools/make_dense_golden.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.robotap import clustering as jax_clustering
from tapnet_tpu.robotap import dense_tracking as jax_dense
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint
from tapnet_tpu_torch.models import tapir
from tapnet_tpu_torch.robotap import clustering, dense_tracking
from tools import make_dense_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 on both sides: summation order of the products and reductions.
VALUE_RTOL = 1e-5
GRAD_TOL = 1e-5
TRACK_TOL = 1e-4
# The trained model on the CPU against the JAX golden: the online golden's
# fp32 limits (PERF.md section 2).
DENSE_GOLDEN_TOL = dict(tracks=0.05, logits=5e-3)

N, T, K = 24, 12, 3
BOUNDARIES = ((0, 7), (7, 12))


def _np(x):
  return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _close(got, want, rtol=VALUE_RTOL):
  want = np.asarray(want)
  np.testing.assert_allclose(_np(got), want, rtol=rtol,
                             atol=rtol * max(np.abs(want).max(), 1e-30))


def _grads_close(got, want):
  for g, w in zip(got, want):
    w = np.asarray(w)
    np.testing.assert_allclose(_np(g), w, rtol=0,
                               atol=GRAD_TOL * max(np.abs(w).max(), 1e-30))


@pytest.fixture(scope="module")
def problem():
  """Tracks of three rigid groups with noise and occlusion, normalized as
  compute_clusters normalizes them, and JAX's initial parameters with
  num_cats = K (the forks moved apart so that every candidate differs)."""
  rng = np.random.RandomState(0)
  group = rng.randint(0, 3, N)
  base = rng.rand(N, 2) * 0.6 + 0.2
  vel = rng.randn(3, 2) * 0.01
  tracks = base[:, None] + vel[group][:, None] * np.arange(T)[None, :, None]
  tracks += rng.randn(N, T, 2) * 1e-3
  vis = (rng.rand(N, T) > 0.15).astype(np.float32)
  pts, vis = tracks.astype(np.float32), vis
  params = jax.jit(jax_clustering.init_params, static_argnames="num_cats")(
      jax.random.PRNGKey(7), jnp.asarray(pts), jnp.asarray(vis), num_cats=K)
  params = jax.tree_util.tree_map(np.asarray, params)
  params = params._replace(
      point_state=rng.randn(N, 64).astype(np.float32) * 0.1,
      cat_pred_fork1=params.cat_pred_fork1 + rng.randn(
          *params.cat_pred_fork1.shape).astype(np.float32) * 0.05,
      cat_pred_fork2=params.cat_pred_fork2 + rng.randn(
          *params.cat_pred_fork2.shape).astype(np.float32) * 0.05)
  return pts, vis, params


def _port(params):
  return clustering.params_from_numpy(params)


# --------------------------------------------------------- projection


@pytest.mark.parametrize("fourdof", [True, False])
def test_projection_matrix_values_and_clipped_gradient(fourdof):
  """In float64 on both sides: the gradient before the clip is a sum of
  terms hundreds of times larger than itself, so float32 would read their
  rounding, not the port."""
  rng = np.random.RandomState(1)
  raw = rng.randn(5, K * 12)
  # Large weights on the output make some incoming gradients pass +-100.
  weight = rng.randn(5, K, 3, 4) * 400
  with jax.enable_x64(True):
    loss = lambda m: jnp.sum(jax_clustering.make_projection_matrix(
        m, fourdof) * weight)
    want, want_grad = jax.value_and_grad(loss)(jnp.asarray(raw))
    mats = jax_clustering.make_projection_matrix(jnp.asarray(raw), fourdof)
    assert mats.dtype == jnp.float64
  assert np.abs(want_grad).max() == 100

  x = torch.tensor(raw, requires_grad=True)
  got_mats = clustering.make_projection_matrix(x, fourdof)
  assert got_mats.shape == (5, K, 3, 4) and got_mats.dtype == torch.float64
  _close(got_mats, mats)
  got = torch.sum(got_mats * torch.from_numpy(weight))
  got.backward()
  _close(got, want)
  _grads_close([x.grad], [want_grad])


def test_project_with_supplied_noise():
  rng = np.random.RandomState(2)
  mats = jax_clustering.make_projection_matrix(
      jnp.asarray(rng.randn(T, K * 12).astype(np.float32)))
  # Depths on both sides of [0.5, 2]: the noise enters out of range.
  pos = (rng.randn(N, K, 3) * 2).astype(np.float32)
  key = jax.random.PRNGKey(3)
  want_xy, want_depth = jax_clustering.project(mats, jnp.asarray(pos), 1.5, key)
  noise = np.asarray(jax.random.normal(key, (N, T, K, 1)))
  xy, depth = clustering.project(torch.tensor(np.asarray(mats)),
                                 torch.tensor(pos), 1.5, torch.tensor(noise))
  assert ((np.asarray(want_depth) == 0.5) | (np.asarray(want_depth) == 2.0)).any()
  _close(xy, want_xy)
  _close(depth, want_depth)


# ----------------------------------------------------------- features


def test_point_and_frame_features(problem):
  pts, vis, params = problem
  want = jax_clustering._point_features(params, jnp.asarray(pts),  # pylint: disable=protected-access
                                        jnp.asarray(vis))
  got = clustering._point_features(_port(params), torch.tensor(pts),  # pylint: disable=protected-access
                                   torch.tensor(vis))
  _close(got, want)
  want = jax_clustering._frame_features(params, BOUNDARIES)  # pylint: disable=protected-access
  got = clustering._frame_features(_port(params), BOUNDARIES)  # pylint: disable=protected-access
  assert got.shape == (T, 128)
  _close(got, want)


def test_predict_matches_jax(problem):
  """The three variants' points and transforms (the port computes them side
  by side), in float64 on both sides: a frame whose two raw rotation rows
  are nearly parallel leaves Gram-Schmidt a small difference to normalize,
  which float32 rounding moves by 1e-3."""
  pts, vis, params = problem
  params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
  pts, vis = pts.astype(np.float64), vis.astype(np.float64)
  with jax.enable_x64(True):
    want = jax_clustering._predict(params, jnp.asarray(pts), jnp.asarray(vis),  # pylint: disable=protected-access
                                   BOUNDARIES, True)
    assert want[0][0].dtype == jnp.float64
  got = clustering._predict(  # pylint: disable=protected-access
      clustering.params_from_numpy(params, dtype=torch.float64),
      torch.tensor(pts), torch.tensor(vis), BOUNDARIES, True)
  for (p, m), (wp, wm) in zip(got, want):
    assert p.shape == (N, K, 3) and m.shape == (T, K, 3, 4)
    _close(p, wp)
    _close(m, wm)


# ------------------------------------------------------------ scoring


@pytest.mark.parametrize("use_em", [False, True])
def test_get_err_and_assignment_loss(use_em):
  rng = np.random.RandomState(4)
  pts = rng.rand(N, T, 2).astype(np.float32)
  vis = (rng.rand(N, T) > 0.2).astype(np.float32)
  pred = (pts[:, :, None] + rng.randn(N, T, K, 2) * 0.01).astype(np.float32)
  want_err = jax_clustering.get_err(jnp.asarray(pts), jnp.asarray(vis),
                                    jnp.asarray(pred))
  err = clustering.get_err(torch.tensor(pts), torch.tensor(vis),
                           torch.tensor(pred))
  _close(err, want_err)
  sum_vis = float(vis.sum())
  want, want_grad = jax.value_and_grad(
      lambda e: jax_clustering.assignment_loss(e, sum_vis, use_em))(want_err)
  e = torch.tensor(np.asarray(want_err), requires_grad=True)
  got = clustering.assignment_loss(e, torch.tensor(sum_vis), use_em)
  got.backward()
  _close(got, want)
  _grads_close([e.grad], [want_grad])


def test_splice_and_drop():
  rng = np.random.RandomState(5)
  base, f1, f2 = (rng.randn(4, 3 * 12).astype(np.float32) for _ in range(3))
  for i in range(3):
    for chunk in (1, 12):
      np.testing.assert_array_equal(
          _np(clustering._splice(*map(torch.tensor, (base, f1, f2)), i, chunk)),  # pylint: disable=protected-access
          jax_clustering._splice(base, f1, f2, i, chunk))  # pylint: disable=protected-access
      np.testing.assert_array_equal(
          _np(clustering._drop(torch.tensor(base), i, chunk)),  # pylint: disable=protected-access
          jax_clustering._drop(base, i, chunk))  # pylint: disable=protected-access


def _jax_draws(key, n_s, f_s, k):
  """JAX loss_fn's own draws from `key`: the sampled points and frames and
  the out-of-bounds noise."""
  k1, k2, k3 = jax.random.split(key, 3)
  return (np.asarray(jax.random.permutation(k1, N))[:n_s],
          np.asarray(jax.random.permutation(k2, T))[:f_s],
          np.asarray(jax.random.normal(k3, (n_s, f_s, k, 1))))


@pytest.mark.parametrize("delete_mode,use_em", [(False, False), (True, False),
                                                (False, True)])
def test_loss_fn_and_gradient(problem, delete_mode, use_em):
  """In float64 on both sides, on JAX's draws: in float32 the gradients
  carry the rounding of the standardizations and the soft distances
  (1e-4 of a leaf apart), not the port's."""
  pts, vis, params = problem
  params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
  pts, vis = pts.astype(np.float64), vis.astype(np.float64)
  key = jax.random.PRNGKey(11)
  n_s, f_s = 20, 10
  kwargs = dict(num_cats=K, delete_mode=delete_mode,
                sequence_boundaries=BOUNDARIES, final_num_cats=2,
                use_em=use_em, fourdof=True, cam_focal_length=1.0)
  with jax.enable_x64(True):
    (want, want_losses), want_grads = jax.jit(
        jax.value_and_grad(jax_clustering.loss_fn, has_aux=True),
        static_argnames=tuple(kwargs) + ("point_sample", "frame_sample"))(
            params, jnp.asarray(pts), jnp.asarray(vis), key,
            point_sample=n_s, frame_sample=f_s, **kwargs)
    assert want.dtype == jnp.float64
    pts_idx, fr_idx, noise = _jax_draws(key, n_s, f_s, K)
  leaves = [x.requires_grad_(True) for x in clustering.param_leaves(
      clustering.params_from_numpy(params, dtype=torch.float64))]
  got, losses = clustering.loss_fn(
      clustering.params_from_leaves(leaves), torch.tensor(pts),
      torch.tensor(vis), torch.tensor(pts_idx), torch.tensor(fr_idx),
      torch.tensor(noise), **kwargs)
  _close(losses, want_losses)
  _close(got, want)
  grads = torch.autograd.grad(got, leaves, materialize_grads=True)
  _grads_close(grads, jax.tree_util.tree_leaves(want_grads))


def test_optimizer_update_with_lr_mul(problem):
  _, _, params = problem
  rng = np.random.RandomState(6)
  leaves = jax.tree_util.tree_leaves(params)
  tx = optax.chain(optax.clip_by_global_norm(1e-3),
                   optax.adam(5e-2, b1=0.9, b2=0.99))
  state = tx.init(params)
  port_state = clustering.optimizer_init(_port(params))
  for lr_mul, scale in ((0.05, 1e-5), (0.5, 1.0)):  # unclipped, clipped
    grads = [rng.randn(*x.shape).astype(np.float32) * scale for x in leaves]
    updates, state = jax.jit(tx.update)(
        jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                     grads), state)
    want = optax.apply_updates(
        params, jax.tree_util.tree_map(lambda u: u * lr_mul, updates))
    like = [torch.tensor(np.asarray(p)) for p in leaves]
    got, port_state = clustering.optimizer_update(
        [torch.tensor(g) for g in grads], port_state, lr_mul)
    got = clustering.unflatten(clustering.flatten(like) + got, like)
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
      _close(g, w)


def test_surgeries_with_supplied_noise(problem):
  _, _, params = problem
  key = jax.random.PRNGKey(12)
  want = jax_clustering._surgery_split(params, 1, key)  # pylint: disable=protected-access
  rngs = jax.random.split(key, 6)
  cat_shape = (params.cat_pred_base.shape[0], K + 1)
  mat_shape = (params.mat_pred_base.shape[0], (K + 1) * 12)
  noise = [torch.tensor(np.asarray(jax.random.normal(k, s))) for k, s in
           zip(rngs[:4], (cat_shape, cat_shape, mat_shape, mat_shape))]
  got = clustering._surgery_split(_port(params), 1, noise)  # pylint: disable=protected-access
  for g, w in zip(clustering.param_leaves(got),
                  jax.tree_util.tree_leaves(want)):
    _close(g, w)
  want = jax_clustering._surgery_delete(params, 2)  # pylint: disable=protected-access
  got = clustering._surgery_delete(_port(params), 2)  # pylint: disable=protected-access
  for g, w in zip(clustering.param_leaves(got),
                  jax.tree_util.tree_leaves(want)):
    np.testing.assert_array_equal(_np(g), w)


# --------------------------------------------------------- end to end


def _two_groups():
  rng = np.random.RandomState(0)
  n_per, t = 24, 20
  base1 = rng.rand(n_per, 2) * 0.3 + 0.1
  base2 = rng.rand(n_per, 2) * 0.3 + 0.6
  frames = np.arange(t)[None, :, None]
  tracks = np.concatenate([base1[:, None] + np.array([0.012, 0.004]) * frames,
                           base2[:, None] + np.array([-0.01, 0.008]) * frames],
                          0) * 100
  return tracks, np.ones((2 * n_per, t)), t


def _same_partition(a, b):
  """The same classes up to their labels."""
  return all(np.array_equal(a == a[i], b == b[i]) for i in range(len(a)))


class JaxDraws:
  """JAX compute_clusters' own draws, replayed for the port's: its key
  sequence from PRNGKey(42) (the initial parameters, a split per step for
  the samples and noise, the surgery's key off the step key it does not
  advance) and PRNGKey(0) for the final assignment."""

  def __init__(self):
    self.rng, self.init_rng = jax.random.split(jax.random.PRNGKey(42))

  def init_params(self, pts, vis):
    return clustering.params_from_numpy(jax_clustering.init_params(
        self.init_rng, jnp.asarray(_np(pts)), jnp.asarray(_np(vis)),
        num_cats=1))

  def step(self, n, t, point_sample, frame_sample, num_cats):
    rng, self.rng = jax.random.split(self.rng)
    k1, k2, k3 = jax.random.split(rng, 3)
    return (torch.tensor(np.asarray(jax.random.permutation(k1, n))[:point_sample]),
            torch.tensor(np.asarray(jax.random.permutation(k2, t))[:frame_sample]),
            torch.tensor(np.asarray(jax.random.normal(
                k3, (point_sample, frame_sample, num_cats, 1)))))

  def surgery(self, params):
    rngs = jax.random.split(jax.random.split(self.rng)[1], 6)
    cat = (params.cat_pred_base.shape[0], params.cat_pred_base.shape[1] + 1)
    mat = (params.mat_pred_base.shape[0], params.mat_pred_base.shape[1] + 12)
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, shape)))
                 for k, shape in zip(rngs[:4], (cat, cat, mat, mat)))

  def final(self, shape):
    return torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                     shape)))


def test_two_rigid_groups_separate_as_in_jax():
  """On JAX's own draws the port's optimization follows JAX's: the same
  partition of the points. (With its own draws the port separates the
  groups about as often as JAX does over other keys: the case is a seed's
  luck in both.)"""
  tracks, vis, t = _two_groups()
  kwargs = dict(final_num_cats=2, max_num_cats=3, iters_before_split=60,
                point_sample=48, frame_sample=20, verbose=False)
  args = ({"ep": tracks}, {"ep": vis}, ["ep"], {"ep": (t, 100, 100, 3)})
  out = clustering.compute_clusters(*args, device="cpu", draws=JaxDraws(),
                                    **kwargs)
  classes = out["classes"]
  assert classes.shape == (48,) and out["num_steps"] == 180
  g1, g2 = classes[:24], classes[24:]
  assert (g1 == g1[0]).mean() > 0.9
  assert (g2 == g2[0]).mean() > 0.9
  assert g1[0] != g2[0]
  want = jax_clustering.compute_clusters(*args, **kwargs)["classes"]
  assert _same_partition(classes, want)


def test_low_visibility_filtered():
  rng = np.random.RandomState(1)
  tracks = rng.rand(10, 8, 2) * 50
  vis = np.ones((10, 8))
  vis[7:] = 0.0
  out = clustering.compute_clusters(
      {"ep": tracks}, {"ep": vis}, ["ep"], {"ep": (8, 50, 50, 3)},
      final_num_cats=1, max_num_cats=2, iters_before_split=10,
      point_sample=10, frame_sample=8, verbose=False, device="cpu")
  assert out["classes"].shape == (7,)


# ----------------------------------------------------- dense tracking

TINY = dict(num_mixer_blocks=2, num_pips_iter=2, pyramid_level=1,
            use_causal_conv=True, initial_resolution=(32, 32),
            blocks_per_group=(1, 1, 1, 1))


def test_track_many_points_matches_jax():
  config = jax_tapir.TapirConfig(**TINY)
  model = jax_tapir.TAPIR(config=config)
  rng = np.random.RandomState(0)
  video = (rng.rand(4, 32, 32, 3) * 255).astype(np.uint8)
  params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
                      jnp.zeros((1, 4, 3)))["params"]
  params = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32) * 0.02,
      params)
  want = jax_dense.track_many_points(video, params, config, num_points=8,
                                     seed=0)
  got = dense_tracking.track_many_points(
      video, params, tapir.TapirConfig(**TINY), num_points=8, seed=0,
      device="cpu")
  np.testing.assert_array_equal(got["query_points"], want["query_points"])
  np.testing.assert_allclose(got["tracks"], want["tracks"], rtol=0,
                             atol=TRACK_TOL)
  np.testing.assert_array_equal(got["visibility"], want["visibility"])
  qts = got["query_points"][:, 0].astype(int)
  for i, qt in enumerate(qts):
    assert not got["visibility"][i, :qt].any()


def test_trained_model_matches_dense_golden():
  golden = np.load(make_dense_golden.OUT)
  params = load_tapir_checkpoint(make_dense_golden.CHECKPOINT)
  video = np.load(make_dense_golden.CLIP)["video"][0]
  out = dense_tracking.track_many_points(
      video, params, tapir.causal_bootstapir_config(),
      num_points=make_dense_golden.NUM_POINTS, seed=make_dense_golden.SEED,
      device="cpu")
  np.testing.assert_array_equal(out["query_points"], golden["query_points"])
  r = make_dense_golden.golden_apart(out, golden, DENSE_GOLDEN_TOL["logits"])
  assert r["track_max_px"] <= DENSE_GOLDEN_TOL["tracks"], r
  assert r["logit_max_abs"] <= DENSE_GOLDEN_TOL["logits"], r
  assert r["flags_apart_elsewhere"] == 0, r
