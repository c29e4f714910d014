"""PyTorch port, TAPNext: the Griffin modules, the ViT-SSM backbone, the
tracker and its two predictors against the JAX package, with the same
seed-made weights through the port's converter.

Modules and the whole tracker run at the TINY config of tests/test_tapnext.py
in float32 (tolerance 1e-5: float32 sums in another order); bfloat16 compute
at the tolerance stated by its test. ViT-B is held to the JAX golden outputs
of tools/make_tapnext_golden.py in float32 (the bfloat16 golden and the
predictor at ViT-B are held on the card by chip_smoke.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from tapnet_tpu import inference as jax_inference
from tapnet_tpu.checkpoints import tapnext_checkpoint as jax_ckpt
from tapnet_tpu.models import rglru as jax_rglru
from tapnet_tpu.models import ssm_vit as jax_ssm_vit
from tapnet_tpu.models import tapnext as jax_tapnext
from tapnet_tpu_torch import inference
from tapnet_tpu_torch.checkpoints import convert, tapnext_checkpoint
from tapnet_tpu_torch.models import rglru, ssm_vit, tapnext
from tapnet_tpu_torch.ops import scan
from tools import make_tapnext_golden
from tools.tapnext_weights import seeded_tapnext_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests/data/tapnext_golden.npz")

TINY = dict(width=32, depth=2, mlp_dim=64, num_heads=2, patch_size=(1, 8, 8),
            image_size=(32, 32))
B, T, Q = 1, 5, 3
TOL = 1e-5


def _configs(**overrides):
  return (jax_ssm_vit.SsmVitConfig(**TINY, **overrides),
          ssm_vit.SsmVitConfig(**TINY, **overrides))


def _clip(seed=0, b=B, t=T, q=Q, size=32):
  rng = np.random.RandomState(seed)
  video = rng.uniform(-1, 1, (b, t, size, size, 3)).astype(np.float32)
  qp = np.stack([rng.randint(0, t, (b, q)).astype(np.float32),
                 rng.uniform(0, size, (b, q)), rng.uniform(0, size, (b, q))],
                -1).astype(np.float32)
  return video, qp


def _random_tree(module, *args, seed=0, scale=0.3, **kwargs):
  """The Flax module's parameter tree, filled with numpy normals."""
  shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda s: (rng.randn(*s.shape) * scale).astype(np.float32),
      shapes["params"])


def _port(module, tree):
  convert.load_tapnext_params(module, tree)
  return module.eval()


def _close(port, ref, tol=TOL):
  np.testing.assert_allclose(port.detach().float().numpy(),
                             np.asarray(ref, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("with_cache", [False, True])
def test_rglru_matches_flax(with_cache):
  c, heads = 32, 2
  x = np.random.RandomState(1).randn(3, 7, c).astype(np.float32)
  h0 = np.random.RandomState(2).randn(3, c).astype(np.float32)
  cache = h0 if with_cache else None
  flax_mod = jax_rglru.RGLRU(num_heads=heads)
  tree = _random_tree(flax_mod, jnp.asarray(x), cache)
  y, h = flax_mod.apply({"params": tree}, jnp.asarray(x), cache)
  mod = _port(rglru.RGLRU(c, heads), tree)
  with torch.no_grad():
    ty, th = mod(torch.from_numpy(x),
                 None if cache is None else torch.from_numpy(cache))
  _close(ty, y)
  _close(th, h)


@pytest.mark.parametrize("t", [1, 2, 7])
@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_flax(t, with_cache):
  c = 16
  x = np.random.RandomState(3).randn(2, t, c).astype(np.float32)
  cache = (np.random.RandomState(4).randn(2, 3, c).astype(np.float32)
           if with_cache else None)
  flax_mod = jax_rglru.CausalConv1D()
  tree = _random_tree(flax_mod, jnp.asarray(x), cache)
  y, new_cache = flax_mod.apply({"params": tree}, jnp.asarray(x), cache)
  mod = _port(rglru.CausalConv1D(c), tree)
  with torch.no_grad():
    ty, tc = mod(torch.from_numpy(x),
                 None if cache is None else torch.from_numpy(cache))
  _close(ty, y)
  _close(tc, new_cache)


@pytest.mark.parametrize("with_cache", [False, True])
def test_griffin_residual_block_matches_flax(with_cache):
  c, heads, mlp = 32, 2, 64
  rng = np.random.RandomState(5)
  x = rng.randn(3, 6, c).astype(np.float32)
  cache = None
  if with_cache:
    cache = jax_rglru.RecurrentBlockCache(
        rg_lru_state=rng.randn(3, c).astype(np.float32),
        conv1d_state=rng.randn(3, 3, c).astype(np.float32))
  flax_mod = jax_rglru.GriffinResidualBlock(
      mlp_expanded_width=mlp, num_heads=heads)
  tree = _random_tree(flax_mod, jnp.asarray(x), cache, scale=0.2)
  y, new_cache = flax_mod.apply({"params": tree}, jnp.asarray(x), cache)
  mod = _port(rglru.GriffinResidualBlock(c, mlp, heads), tree)
  tcache = None if cache is None else rglru.RecurrentBlockCache(
      *(torch.from_numpy(v) for v in cache))
  with torch.no_grad():
    ty, tc = mod(torch.from_numpy(x), tcache)
  _close(ty, y)
  _close(tc.rg_lru_state, new_cache.rg_lru_state)
  _close(tc.conv1d_state, new_cache.conv1d_state)


@pytest.mark.parametrize("masks", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["none", "image2image", "query2image", "both"])
def test_vit_block_matches_flax(masks):
  c, heads, n, ni = 32, 2, 10, 6
  x = np.random.RandomState(6).randn(2, n, c).astype(np.float32)
  flax_mod = jax_ssm_vit.ViTBlock(
      num_heads=heads, mlp_dim=64, mask_image2image=masks[0],
      mask_query2image=masks[1], num_image_tokens=ni)
  tree = _random_tree(flax_mod, jnp.asarray(x), scale=0.2)
  y, out = flax_mod.apply({"params": tree}, jnp.asarray(x))
  mod = _port(ssm_vit.ViTBlock(c, heads, 64, torch.float32, masks[0],
                               masks[1], ni), tree)
  with torch.no_grad():
    ty, tout = mod(torch.from_numpy(x))
  _close(ty, y)
  _close(tout["+mlp"], out["+mlp"])


def test_embed_queries_and_hints_matches_flax():
  """Several hints per track, hints before, inside and after the clip,
  fractional and negative times (truncated toward zero), padded hints."""
  jcfg, tcfg = _configs()
  params = seeded_tapnext_params(jcfg, seed=1)["backbone"]
  qp = np.array([[[[2.7, 3.0, 4.0], [0.0, 30.5, 1.0], [4.2, 16.0, 16.0]],
                  [[-0.5, 8.0, 9.0], [6.0, 1.0, 1.0], [3.0, 31.9, 0.1]],
                  [[1.0, 12.0, 13.0], [1.0, 20.0, 21.0], [-3.0, 5.0, 5.0]]],
                 [[[4.0, 2.0, 2.0], [2.0, 7.5, 7.5], [0.0, 9.0, 9.0]],
                  [[3.9, 0.0, 31.0], [2.0, 5.0, 6.0], [1.5, 25.0, 3.0]],
                  [[0.0, 16.0, 16.0], [4.0, 16.0, 16.0], [5.0, 1.0, 2.0]]]],
                np.float32)
  pad = np.array([[[1, 1, 1], [1, 0, 1], [0, 1, 1]],
                  [[1, 1, 0], [1, 1, 1], [1, 1, 1]]], bool)
  dec = jax_ssm_vit.MaskedSequenceDecoder(config=jcfg)
  ref = dec.apply({"params": params}, T, jnp.asarray(qp), jnp.asarray(pad),
                  method=jax_ssm_vit.MaskedSequenceDecoder.embed_queries_and_hints)
  mod = _port(ssm_vit.MaskedSequenceDecoder(tcfg), params)
  with torch.no_grad():
    tokens = mod.embed_queries_and_hints(T, torch.from_numpy(qp),
                                         torch.from_numpy(pad))
  assert tokens.shape == (2, T, 3, TINY["width"])
  _close(tokens, ref)


# ------------------------------------------------------------ the tracker


@pytest.mark.parametrize("overrides", [
    {}, dict(mask_image2image=True, mask_query2image=True),
    dict(bidirectional_ssm=True), dict(posemb="sincos", posemb_full="sincos"),
], ids=["default", "masks", "bidirectional", "sincos"])
def test_tracker_matches_flax_with_intermediates(overrides):
  jcfg, tcfg = _configs(**overrides)
  params = seeded_tapnext_params(jcfg, seed=0)
  video, qp = _clip()
  ref = jax_tapnext.TAPNextTracker(config=jcfg).apply(
      {"params": params}, jnp.asarray(video), jnp.asarray(qp))
  model = _port(tapnext.TAPNextTracker(tcfg), params)
  with torch.no_grad():
    out = model(torch.from_numpy(video), torch.from_numpy(qp))
  # Tracks are bin positions in [0, 256): 1e-5 of the logits' float32 noise
  # moves them by up to 256 * 1e-5 / temperature.
  _close(out.tracks, ref.tracks, 2e-4)
  _close(out.track_logits, ref.track_logits)
  _close(out.visible_logits, ref.visible_logits)
  assert len(out.intermediate_tracks) == TINY["depth"]
  for name in ("tracks", "track_logits", "visible_logits"):
    for mine, theirs in zip(getattr(out, f"intermediate_{name}"),
                            getattr(ref, f"intermediate_{name}")):
      _close(mine, theirs, 2e-4 if name == "tracks" else TOL)


def test_tracker_bf16_compute_matches_flax():
  """compute_dtype="bfloat16": the ViT products in bf16 on both sides, which
  round at other points (Flax's softmax in bf16, the port's fused attention
  in float32): held to 2e-2 on the logits, whose range is about 3, and 0.05
  px on the tracks."""
  jcfg, tcfg = _configs(compute_dtype="bfloat16")
  params = seeded_tapnext_params(jcfg, seed=0)
  video, qp = _clip()
  ref = jax_tapnext.TAPNextTracker(config=jcfg).apply(
      {"params": params}, jnp.asarray(video), jnp.asarray(qp))
  model = _port(tapnext.TAPNextTracker(tcfg), params)
  with torch.no_grad():
    out = model(torch.from_numpy(video), torch.from_numpy(qp))
  assert out.tracks.dtype == torch.float32
  _close(out.track_logits, ref.track_logits, 2e-2)
  _close(out.visible_logits, ref.visible_logits, 2e-2)
  _close(out.tracks, ref.tracks, 5e-2)


def test_forward_step_chunks_equal_offline():
  """In the port: a warm-up chunk with the queries and chunks carrying the
  state give the offline outputs (the recurrence is exact; attention is per
  frame). The fresh sequence skips the t = 0 normalization only in the first
  chunk."""
  _, tcfg = _configs()
  params = seeded_tapnext_params(tcfg, seed=2)
  video, qp = _clip(seed=3, t=7)
  model = _port(tapnext.TAPNextTracker(tcfg), params)
  v, q = torch.from_numpy(video), torch.from_numpy(qp)
  with torch.no_grad():
    offline = model(v, q, intermediates=False)
    res = model.forward_step(v[:, :3], q)
    chunks = [res]
    for start in (3, 4):
      stop = start + 1 if start == 3 else 7
      res = model.forward_step(v[:, start:stop], state=res.state)
      chunks.append(res)
  assert res.state.step == 7
  for name in ("tracks", "track_logits", "visible_logits"):
    joined = torch.cat([getattr(r, name) for r in chunks], dim=2)
    torch.testing.assert_close(joined, getattr(offline, name),
                               rtol=TOL, atol=2e-4 if name == "tracks" else TOL)


def test_tracker_certainty_matches_jax():
  rng = np.random.RandomState(7)
  logits = rng.randn(2, 3, 4, 512).astype(np.float32) * 3
  tracks = rng.uniform(0, 256, (2, 3, 4, 2)).astype(np.float32)
  ref = jax_tapnext.tracker_certainty(jnp.asarray(tracks), jnp.asarray(logits))
  got = tapnext.tracker_certainty(torch.from_numpy(tracks),
                                  torch.from_numpy(logits))
  _close(got, ref)


# ------------------------------------------------------------- predictors


@pytest.mark.parametrize("chunk_size,query_bucket", [(None, None), (2, None),
                                                     (2, 4)])
def test_predictor_matches_jax(chunk_size, query_bucket):
  jcfg, tcfg = _configs()
  params = seeded_tapnext_params(jcfg, seed=4)
  video, qp = _clip(seed=5)
  ref = jax_inference.TapnextPredictor(
      params, jcfg, query_bucket=query_bucket, chunk_size=chunk_size)(video, qp)
  before = scan.LAUNCHES
  out = inference.TapnextPredictor(
      params, tcfg, query_bucket=query_bucket, chunk_size=chunk_size,
      device="cpu")(video, qp)
  assert scan.LAUNCHES == before  # CPU tensors take the plain version
  assert out["expected_dist"] is None
  assert out["tracks"].shape == (B, Q, T, 2)
  np.testing.assert_allclose(out["tracks"], ref["tracks"], atol=2e-4, rtol=0)
  np.testing.assert_allclose(out["occlusion"], ref["occlusion"], atol=TOL,
                             rtol=TOL)


def test_online_predictor_matches_jax():
  jcfg, tcfg = _configs()
  params = seeded_tapnext_params(jcfg, seed=6)
  video, qp = _clip(seed=7)
  qp[..., 0] = 0
  ref = jax_inference.OnlineTapnextPredictor(params, jcfg)
  port = inference.OnlineTapnextPredictor(params, tcfg, device="cpu")
  with pytest.raises(ValueError, match="init"):
    port.predict(video[:, 1])
  r_tracks, r_vis = ref.init(video[:, :1], qp)
  p_tracks, p_vis = port.init(video[:, :1], qp)
  np.testing.assert_allclose(p_tracks, r_tracks, atol=2e-4, rtol=0)
  np.testing.assert_allclose(p_vis, r_vis, atol=TOL, rtol=TOL)
  for t in range(1, T):
    r_tracks, r_vis = ref.predict(video[:, t])
    p_tracks, p_vis = port.predict(video[:, t])
    assert p_tracks.shape == (B, Q, 2) and p_vis.dtype == bool
    np.testing.assert_allclose(p_tracks, r_tracks, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(p_vis, r_vis)


# ------------------------------------------------------- weights and golden


@pytest.mark.parametrize("variant", ["tiny", "B"])
def test_seeded_weights_match_the_model_tree(variant):
  """tools/tapnext_weights.py makes exactly the keys and shapes of the JAX
  model's parameters (ViT-B: 244.5 M), and the port's model holds as many."""
  if variant == "tiny":
    jcfg, tcfg = _configs()
  else:
    jcfg, tcfg = jax_ssm_vit.SsmVitConfig(), ssm_vit.SsmVitConfig()
  h, w = jcfg.image_size
  shapes = jax.eval_shape(
      jax_tapnext.TAPNextTracker(config=jcfg).init, jax.random.PRNGKey(0),
      jnp.zeros((1, 2, h, w, 3)), jnp.zeros((1, 3, 3)))["params"]
  want = {"/".join(str(k.key) for k in path): leaf.shape
          for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
  params = seeded_tapnext_params(jcfg, seed=0)
  got = {k: v.shape for k, v in tapnext_checkpoint.flatten(params).items()}
  assert got == want
  count = sum(int(np.prod(s)) for s in want.values())
  if variant == "B":
    assert count == 244_534_529
  # The port's modules on the meta device (no memory for ViT-B).
  with torch.device("meta"):
    model = tapnext.TAPNextTracker(tcfg)
  assert sum(p.numel() for p in model.parameters()) == count
  assert len(model.state_dict()) == len(want)


def test_converter_refuses_unknown_leaves():
  _, tcfg = _configs()
  params = seeded_tapnext_params(tcfg, seed=0)
  params["backbone"]["embedding"]["stray"] = np.zeros(3, np.float32)
  with pytest.raises(ValueError, match="Unmapped"):
    convert.load_tapnext_params(tapnext.TAPNextTracker(tcfg), params)


def test_checkpoint_copy_matches_jax(tmp_path):
  """The port's copy of the checkpoint module: npz round trip and the
  bicubic position-embedding resize equal the JAX package's."""
  jcfg, _ = _configs()
  params = seeded_tapnext_params(jcfg, seed=8)
  path = str(tmp_path / "ckpt.npz")
  jax_ckpt.save_tapnext_checkpoint(path, params)
  flat = tapnext_checkpoint.flatten(tapnext_checkpoint.load_tapnext_checkpoint(path))
  ref = jax_ckpt.flatten(params)
  assert flat.keys() == ref.keys()
  assert all(np.array_equal(flat[k], ref[k]) for k in ref)
  new = jax_ssm_vit.SsmVitConfig(**dict(TINY, image_size=(48, 48)))
  got = tapnext_checkpoint.flatten(tapnext_checkpoint.adapt_posembs(params, jcfg, new))
  want = jax_ckpt.flatten(jax_ckpt.adapt_posembs(params, jcfg, new))
  assert got["backbone/pos_embedding"].shape == (1, 36, TINY["width"])
  assert all(np.array_equal(got[k], want[k]) for k in want)


def test_vit_b_matches_jax_golden_fp32():
  """ViT-B (SsmVitConfig()) with the seed-0 weights on the golden clip
  against the JAX outputs: logits within 2e-3, tracks within 0.05 px for at
  least 99% of point-frames (a near-tied coordinate bin may flip)."""
  golden = np.load(GOLDEN)
  cfg = ssm_vit.SsmVitConfig()
  video, qp = make_tapnext_golden.golden_clip()
  model = _port(tapnext.TAPNextTracker(cfg), seeded_tapnext_params(cfg, 0))
  with torch.inference_mode():
    out = model(torch.from_numpy(video), torch.from_numpy(qp),
                intermediates=False)
  for name in ("track_logits", "visible_logits"):
    np.testing.assert_allclose(out.__dict__[name].numpy(),
                               golden[f"float32_call_{name}"], atol=2e-3, rtol=0)
  err = np.abs(out.tracks.numpy() - golden["float32_call_tracks"]).max(-1)
  assert np.mean(err <= 0.05) >= 0.99, err.max()
