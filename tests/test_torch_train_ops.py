"""PyTorch port, the pieces of TAPNext training against the JAX package: the
scan's gradients (the plain backward against `jax.vjp` of the JAX
`linear_scan`, through the Pallas kernel in interpret mode and through the
associative scan), the clipped sqrt, the losses, the learning-rate schedule,
the optimizer chain against optax's, the weight-decay mask, the
initialisation against Flax's, the inverse converter and the synthetic
renderer on JAX's own draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from tapnet_tpu.data import synthetic as jax_synthetic
from tapnet_tpu.models import rglru as jax_rglru
from tapnet_tpu.models import ssm_vit as jax_ssm_vit
from tapnet_tpu.models import tapnext as jax_tapnext
from tapnet_tpu.models import tapnext_losses as jax_losses
from tapnet_tpu.ops import scan as jax_scan
from tapnet_tpu.training import optimizers as jax_opt
from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.checkpoints.tapnext_checkpoint import flatten
from tapnet_tpu_torch.data import synthetic
from tapnet_tpu_torch.models import rglru, ssm_vit, tapnext, tapnext_losses
from tapnet_tpu_torch.ops import scan
from tapnet_tpu_torch.training import optimizers

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# The scan's gradients: fp32 sums in another order or with other
# contractions (the forward's 1e-5 of tests/test_torch_scan.py); bf16 I/O:
# dx and da rounded to bf16 on both sides, a step apart at most (2^-8).
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMALL = dict(width=64, depth=2, mlp_dim=128, num_heads=2, image_size=(32, 32))


@pytest.fixture(params=["pallas_interpret", "associative_scan"])
def jax_route(request):
  jax_scan.FORCE_INTERPRET = request.param == "pallas_interpret"
  yield request.param
  jax_scan.FORCE_INTERPRET = False


def _scan_case(shape, dtype, carried, seed):
  b, t, c = shape
  rng = np.random.RandomState(seed)
  x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(TDT[dtype])
  a = torch.from_numpy((rng.rand(b, t, c) * 0.25 + 0.7).astype(np.float32)
                       ).to(TDT[dtype])
  h0 = torch.from_numpy(rng.randn(b, c).astype(np.float32) if carried
                        else np.zeros((b, c), np.float32))
  dy = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(TDT[dtype])
  dh_last = torch.from_numpy(rng.randn(b, c).astype(np.float32))
  return x, a, h0, dy, dh_last


def _to_jax(t):
  return jnp.asarray(t.float().numpy()).astype(
      JDT["bfloat16" if t.dtype == torch.bfloat16 else "float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["h0_zero", "h0_carried"])
@pytest.mark.parametrize("use_h_last", [False, True],
                         ids=["dh_last_unused", "dh_last_used"])
def test_scan_gradients_match_jax(jax_route, dtype, carried, use_h_last):
  _check_scan_gradients((2, 8, 16), dtype, carried, use_h_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_step_scan_gradients_match_jax(dtype):
  """T == 1: the one-step formula under plain autograd, launching nothing;
  JAX's backward takes its XLA route there too."""
  before = scan.BACKWARD_LAUNCHES
  _check_scan_gradients((3, 1, 130), dtype, True, True)
  assert scan.BACKWARD_LAUNCHES == before


def _check_scan_gradients(shape, dtype, carried, use_h_last):
  x, a, h0, dy, dh_last = _scan_case(shape, dtype, carried, seed=7)
  args = [t.clone().requires_grad_() for t in (x, a, h0)]
  y, h_last = scan.linear_scan(*args)
  if use_h_last:
    grads = torch.autograd.grad((y, h_last), args, (dy, dh_last))
  else:
    grads = torch.autograd.grad(y, args, dy)
  _, vjp = jax.vjp(jax_scan.linear_scan, *(_to_jax(t) for t in (x, a, h0)))
  ref = vjp((_to_jax(dy),
             _to_jax(dh_last) if use_h_last else jnp.zeros(h0.shape)))
  tol = SCAN_TOL[dtype]
  for got, want in zip(grads, ref):
    assert got.dtype == {jnp.dtype("bfloat16"): torch.bfloat16}.get(
        want.dtype, torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_mirrors_jax_order(dtype):
  """The plain backward makes JAX's `_scan_bwd` roundings: g in float32, one
  multiply and one add per step, dh_last folded into the last dy, h0 rounded
  to y's dtype in da's first step; autograd's missing cotangents (None)
  count as zeros."""
  x, a, h0, dy, dh_last = _scan_case((3, 12, 130), dtype, True, seed=8)
  y, _ = scan.linear_scan_reference(x, a, h0)
  dx, da, dh0 = scan.linear_scan_backward_reference(dy, dh_last, a, h0, y)
  g = dy[:, -1].float() + dh_last
  for t in range(11, -1, -1):
    if t < 11:
      g = torch.add(torch.mul(a[:, t + 1].float(), g), dy[:, t].float())
    assert torch.equal(dx[:, t], g.to(x.dtype))
    prev = h0.to(y.dtype).float() if t == 0 else y[:, t - 1].float()
    assert torch.equal(da[:, t], (g * prev).to(a.dtype))
  assert torch.equal(dh0, a[:, 0].float() * g)
  none = scan.linear_scan_backward_reference(None, None, a, h0, y)
  zero = scan.linear_scan_backward_reference(torch.zeros_like(dy), None, a, h0, y)
  for n, z in zip(none, zero):
    assert torch.equal(n, z)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_controls_differ_from_plain(dtype):
  x, a, h0, dy, dh_last = _scan_case((3, 50, 130), dtype, True, seed=9)
  y, _ = scan.linear_scan_reference(x, a, h0)
  ref = scan.linear_scan_backward_reference(dy, dh_last, a, h0, y)
  controls = scan.scan_backward_controls(dy, dh_last, a, h0, y)
  assert ("h0_unrounded" in controls) == (dtype == "bfloat16")
  for name, faulty in controls.items():
    assert [f.dtype for f in faulty] == [r.dtype for r in ref], name
    assert not all(torch.equal(f, r) for f, r in zip(faulty, ref)), name


def test_sqrt_bound_derivative_matches_jax():
  """Away from 0 the gradient is 1 / (2 sqrt(x)); near 0 (a near 1) it is
  clipped at 1000, as JAX's custom VJP."""
  x = np.array([1e-9, 1e-7, 2.5e-7, 1e-6, 1e-3, 0.25, 0.9], np.float32)
  xt = torch.from_numpy(x).requires_grad_()
  y = rglru.sqrt_bound_derivative(xt)
  got, = torch.autograd.grad(y.sum(), xt)
  want = jax.grad(lambda v: jax_rglru.sqrt_bound_derivative(v).sum())(
      jnp.asarray(x))
  np.testing.assert_allclose(y.detach().numpy(), np.sqrt(x), rtol=1e-7)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
  assert float(got.max()) == pytest.approx(1000.0, rel=1e-6)


def _loss_inputs(seed=0, b=2, q=3, t=5):
  rng = np.random.RandomState(seed)
  tracks = rng.uniform(-10, 265, (b, q, t, 2)).astype(np.float32)
  target = rng.uniform(-10, 265, (b, q, t, 2)).astype(np.float32)
  # Targets on .5 boundaries: the label rounds half to even.
  target[0, 0, :, 0] = np.array([0.5, 1.0, 2.0, 3.0, 128.0])
  logits = (rng.randn(b, q, t, 512) * 3).astype(np.float32)
  vis_logits = rng.randn(b, q, t, 1).astype(np.float32)
  visible = (rng.rand(b, q, t) > 0.3).astype(np.float32)
  return tracks, target, logits, vis_logits, visible


def _grad_pair(port_fn, jax_fn, arrays):
  """Values and gradients of sum(fn(arrays)) on both sides."""
  ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
  out = port_fn(*ts)
  grads = torch.autograd.grad(out.sum(), ts, allow_unused=True)
  jv, jgrads = jax.value_and_grad(
      lambda *xs: jnp.sum(jax_fn(*xs)), argnums=tuple(range(len(arrays))))(
          *(jnp.asarray(a) for a in arrays))
  return out, grads, jax_fn(*(jnp.asarray(a) for a in arrays)), jgrads


# The losses: float32 on both sides, sums in another order: 1e-5.
LOSS_TOL = 1e-5


@pytest.mark.parametrize("name", ["huber", "masked_l1_patches",
                                  "coordinate_cross_entropy", "certainty"])
def test_losses_and_gradients_match_jax(name):
  tracks, target, logits, vis_logits, _ = _loss_inputs()
  rng = np.random.RandomState(1)
  cases = {
      "huber": ((tracks, target), {}),
      "masked_l1_patches": ((rng.randn(2, 3, 4, 4, 3).astype(np.float32),
                             rng.randn(2, 3, 4, 4, 3).astype(np.float32)), {}),
      "coordinate_cross_entropy": ((logits, target), {}),
      "certainty": ((vis_logits, tracks, target), {}),
  }
  arrays, _ = cases[name]
  out, grads, want, jgrads = _grad_pair(
      getattr(tapnext_losses, name), getattr(jax_losses, name), arrays)
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                             rtol=LOSS_TOL, atol=LOSS_TOL)
  for g, jg in zip(grads, jgrads):
    jg = np.asarray(jg)
    if g is None:  # no path (labels, stop_gradient): JAX's are zero
      assert not jg.any()
    else:
      np.testing.assert_allclose(g.numpy(), jg, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_tapnext_loss_matches_jax():
  """The combined loss with two intermediate heads: every scalar, and the
  gradients of the loss in every head's outputs."""
  tracks, target, logits, vis_logits, visible = _loss_inputs()
  rng = np.random.RandomState(2)
  heads = [(tracks + rng.randn(*tracks.shape).astype(np.float32),
            logits + rng.randn(*logits.shape).astype(np.float32),
            vis_logits + rng.randn(*vis_logits.shape).astype(np.float32))
           for _ in range(3)]
  flat = [a for h in heads for a in h]

  def results(ns, xs):
    return ns(tracks=xs[0], track_logits=xs[1], visible_logits=xs[2],
              intermediate_tracks=[xs[3], xs[6]],
              intermediate_track_logits=[xs[4], xs[7]],
              intermediate_visible_logits=[xs[5], xs[8]])

  from types import SimpleNamespace
  ts = [torch.from_numpy(a).requires_grad_() for a in flat]
  loss, scalars = tapnext_losses.tapnext_loss(
      results(SimpleNamespace, ts), torch.from_numpy(target),
      torch.from_numpy(visible))
  grads = torch.autograd.grad(loss, ts)
  (jloss, jscalars), jgrads = jax.value_and_grad(
      lambda xs: jax_losses.tapnext_loss(
          results(SimpleNamespace, xs), jnp.asarray(target),
          jnp.asarray(visible)), has_aux=True)([jnp.asarray(a) for a in flat])
  assert set(scalars) == set(jscalars)
  for k, v in jscalars.items():
    assert float(scalars[k].detach()) == pytest.approx(float(v), rel=LOSS_TOL), k
  for g, jg in zip(grads, jgrads):
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=LOSS_TOL,
                               atol=1e-7)


@pytest.mark.parametrize("kwargs,total", [
    (dict(schedule_type="cosine", warmup_steps=10, base_lr=1e-3), 100),
    (dict(schedule_type="cosine", warmup_steps=10, base_lr=1e-3, init_value=1e-5,
          end_value=1e-5), 100),
    (dict(schedule_type="cosine", warmup_steps=0, base_lr=2e-3), 50),
    (dict(schedule_type="constant_cosine", base_lr=1e-4, end_value=1e-6), 100),
])
def test_schedule_matches_optax(kwargs, total):
  """At steps 0, 1, the warmup's end, mid-decay, the end and past it;
  float32 on both sides (the cosine may differ in its last bit)."""
  port = optimizers.make_lr_schedule(optimizers.OptimizerConfig(**kwargs), total)
  ref = jax_opt.make_lr_schedule(jax_opt.OptimizerConfig(**kwargs), total)
  warm = kwargs.get("warmup_steps", 0)
  for step in sorted({0, 1, warm, warm + 1, (warm + total) // 2, total - 1,
                      total, total + 5}):
    assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step
  if kwargs.get("init_value", 0.0) == 0.0 and warm:
    assert port(0) == 0.0


def _small_tree(seed=0):
  return tapnext.init_tapnext_params(ssm_vit.SsmVitConfig(**SMALL),
                                     torch.Generator().manual_seed(seed))


def _port_names(tree):
  model = tapnext.TAPNextTracker(ssm_vit.SsmVitConfig(**SMALL))
  convert.load_tapnext_params(model, tree)
  return {n: p.detach().clone() for n, p in model.named_parameters()}


def _flax(named):
  return flatten(convert.state_dict_to_tapnext(named, SMALL["num_heads"],
                                               (1, 8, 8)))


def test_weight_decay_mask_matches_jax():
  """The decayed set is JAX's leaf by leaf (decided on Flax leaf names), so
  the block-diagonal gates' and the conv's `b`, `a_param`, the tokens and
  the position embeddings are decayed; biases and norm scales are not."""
  tree = _small_tree()
  named = _port_names(tree)
  mask = optimizers.weight_decay_mask(named)
  jmask = flatten(jax_opt.weight_decay_mask(tree))
  flat_mask = {"/".join(convert.tapnext_flax_path(n)): m for n, m in mask.items()}
  assert flat_mask == {k: bool(v) for k, v in jmask.items()}
  for name in ("backbone.Transformer.encoderblock_0.ssm_block.recurrent_block."
               "rg_lru.input_gate.b",
               "backbone.Transformer.encoderblock_0.ssm_block.recurrent_block."
               "conv_1d.b",
               "backbone.Transformer.encoderblock_1.ssm_block.mlp_block.ffw_up.b",
               "backbone.Transformer.encoderblock_0.ssm_block.recurrent_block."
               "rg_lru.a_param", "backbone.mask_token", "backbone.pos_embedding"):
    assert mask[name], name
  assert not mask["backbone.embedding.bias"]
  assert not mask["backbone.Transformer.encoderblock_0.ssm_block."
                  "temporal_pre_norm.scale"]


def test_optimizer_matches_optax_chain():
  """Three updates of the full chain (clipping, Adam, masked decay, the
  schedule, fast variables) and a fourth with a NaN gradient, which is
  skipped (zero update, state kept) and counted, against optax's. float32
  on both sides; the global norm sums in another order (1e-7 relative), and
  where Adam's first moment cancels that error is left bare, so an update is
  held within 1e-5 of itself plus 1e-6 of its leaf's largest update, a
  parameter within 1e-6 of itself plus 1e-6 of its leaf's largest."""
  cfg = dict(base_lr=1e-2, warmup_steps=2, weight_decay=0.1, max_norm=1.0,
             fast_variables=("rg_lru",), fast_lr_multiplier=10.0)
  tree = _small_tree(1)
  named = _port_names(tree)
  port_cfg = optimizers.OptimizerConfig(**cfg)
  tx = optimizers.make_optimizer(port_cfg, optimizers.make_lr_schedule(port_cfg, 20))
  jcfg = jax_opt.OptimizerConfig(**cfg)
  jtx = jax_opt.make_optimizer(jcfg, jax_opt.make_lr_schedule(jcfg, 20))
  jparams = jax.tree_util.tree_map(jnp.asarray, tree)
  state, jstate = tx.init(named), jtx.init(jparams)
  jupdate = jax.jit(jtx.update)
  rng = np.random.RandomState(3)
  for step in range(4):
    grads = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
             for n, p in named.items()}
    if step == 3:
      grads["backbone.mask_token"][0, 0, 0, 0] = float("nan")
    updates, state = tx.update(grads, state, named)
    optimizers.apply_updates(named, updates)
    jgrads = jax.tree_util.tree_map(
        jnp.asarray, convert.state_dict_to_tapnext(grads, 2, (1, 8, 8)))
    jupdates, jstate = jupdate(jgrads, jstate, jparams)
    jparams = optax.apply_updates(jparams, jupdates)
    got, want = _flax(updates), flatten(jax.tree_util.tree_map(np.asarray, jupdates))
    for k in want:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                 atol=1e-6 * np.abs(want[k]).max(),
                                 err_msg=f"step {step} {k}")
    if step == 3:
      assert all(not u.any() for u in updates.values())
  got = _flax(named)
  for k, v in flatten(jax.tree_util.tree_map(np.asarray, jparams)).items():
    np.testing.assert_allclose(got[k], v, rtol=1e-6,
                               atol=1e-6 * np.abs(v).max(), err_msg=k)
  assert state["notfinite_count"] == int(jstate.notfinite_count) == 1
  assert state["total_notfinite"] == int(jstate.total_notfinite) == 1
  assert state["last_finite"] is False and not bool(jstate.last_finite)
  assert state["count"] == 3 and state["adam_count"] == 3


def test_init_matches_flax_initialisers():
  """`init_tapnext_params` against Flax's `model.init`: the same tree and
  shapes, the exact constants (zero biases, unit LayerNorm scales, zero
  RMSNorm scales), and per random leaf the same spread: standard deviations
  within 10% on leaves of 4,096 or more elements (a few percent of sampling
  noise), and within the Xavier limit for the uniform kernels."""
  tree = _small_tree(2)
  model = jax_tapnext.TAPNextTracker(jax_ssm_vit.SsmVitConfig(**SMALL))
  ref = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
                            jnp.zeros((1, 3, 3)))["params"]
  got, want = flatten(tree), flatten(jax.tree_util.tree_map(np.asarray, ref))
  assert set(got) == set(want)
  for k, w in want.items():
    g = got[k]
    assert g.shape == w.shape and g.dtype == np.float32, k
    if w.std() == 0:
      assert np.array_equal(g, w), k
    elif w.size >= 4096:
      assert g.std() == pytest.approx(w.std(), rel=0.1), k
      assert np.abs(g).max() <= 2.5 * w.std() / 0.87962566 * 1.01 or (
          "pos_embedding" in k or "token" in k), k


def test_inverse_converter_round_trips():
  tree = _small_tree(3)
  model = tapnext.TAPNextTracker(ssm_vit.SsmVitConfig(**SMALL))
  convert.load_tapnext_params(model, tree)
  back = convert.state_dict_to_tapnext(dict(model.named_parameters()),
                                       SMALL["num_heads"], (1, 8, 8))
  a, b = flatten(tree), flatten(back)
  assert set(a) == set(b)
  for k in a:
    assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
  with pytest.raises(ValueError, match="Unmapped"):
    convert.state_dict_to_tapnext({"x.y.unknown": torch.zeros(2)}, 2, (1, 8, 8))


def test_renderer_matches_make_batch_on_jax_draws():
  """`render_batch` on the draws JAX's `make_batch` makes from its keys
  (one key per example, split in 8) gives its batch: the video within 1e-6
  (bilinear resize and the texture contraction sum in other orders), the
  points within 1e-6 (XLA may contract a track's multiply-add into one
  rounding) and the occlusion exactly."""
  b, t, h, w, q, s, vr = 2, 3, 32, 32, 8, 6, 3.0
  rng = jax.random.PRNGKey(5)
  ref = jax_synthetic.make_batch(rng, b, t, h, w, q, s, vr)
  draws = {k: [] for k in ("bg_small", "pos0", "vel", "half", "tex_small",
                           "sprite_id", "offset", "t_query")}
  for key in jax.random.split(rng, b):
    keys = jax.random.split(key, 8)
    draws["bg_small"].append(jax.random.uniform(keys[0], (8, 8, 3)))
    draws["pos0"].append(jax.random.uniform(
        keys[1], (s, 2), minval=jnp.array([h * 0.2, w * 0.2]),
        maxval=jnp.array([h * 0.8, w * 0.8])))
    draws["vel"].append(jax.random.uniform(keys[2], (s, 2), minval=-vr, maxval=vr))
    draws["half"].append(jax.random.uniform(keys[3], (s, 1), minval=h * 0.06,
                                            maxval=h * 0.18))
    draws["tex_small"].append(jax.random.uniform(keys[4], (s, 8, 8, 3)))
    draws["sprite_id"].append(jax.random.randint(keys[5], (q,), 0, s))
    draws["offset"].append(jax.random.uniform(keys[6], (q, 2), minval=-0.9,
                                              maxval=0.9))
    draws["t_query"].append(jax.random.randint(keys[7], (q,), 0, t))
  draws = {k: torch.from_numpy(np.stack([np.asarray(v) for v in vs]))
           for k, vs in draws.items()}
  draws["sprite_id"] = draws["sprite_id"].long()
  draws["t_query"] = draws["t_query"].long()
  got = synthetic.render_batch(draws, t, h, w)
  np.testing.assert_allclose(got["video"].numpy(), np.asarray(ref["video"]),
                             atol=1e-6, rtol=0)
  for k in ("query_points", "target_points"):
    np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                               atol=0, err_msg=k)
  np.testing.assert_array_equal(got["occluded"].numpy(),
                                np.asarray(ref["occluded"]))
  assert 0 < float(got["occluded"].mean()) < 1


def test_make_batch_draws_from_the_generator():
  """The port's batches are made from its torch.Generator: one seed, one
  batch; shapes and ranges as JAX's."""
  one = synthetic.make_batch(torch.Generator().manual_seed(0), 2, 3, 32, 32, 5)
  two = synthetic.make_batch(torch.Generator().manual_seed(0), 2, 3, 32, 32, 5)
  for k in one:
    assert torch.equal(one[k], two[k]), k
  assert one["video"].shape == (2, 3, 32, 32, 3)
  assert one["query_points"].shape == (2, 5, 3)
  assert one["target_points"].shape == (2, 5, 3, 2)
  assert float(one["video"].min()) >= -1 and float(one["video"].max()) <= 1
  it = synthetic.batch_iterator(seed=0, device="cpu", batch_size=1,
                                num_frames=2, height=16, width=16, num_queries=3)
  first, second = next(it), next(it)
  assert not torch.equal(first["video"], second["video"])
