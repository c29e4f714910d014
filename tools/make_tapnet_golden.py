"""Writes golden TAP-Net outputs and training numbers of the JAX package for
the PyTorch port, and holds the port's to them.

Runs the JAX package's full-width TAP-Net (`TapNetConfig()`: TSM-ResNet-18,
stride 8, the unit_2 endpoint) on the CPU with the seed-made weights and
running statistics of tools/tapnet_weights.py (seed WEIGHT_SEED) on the
8-frame 256x256 clip of tools/golden_clip.py and its 32 query points, in
chunks of CHUNK queries, with targets made by `golden_batch` (numpy seed
TARGET_SEED: each query's point moving in a straight line, a fifth of the
samples occluded, visible on its query frame):

  eval_tracks, eval_occlusion      the forward with the running statistics
  train_tracks, train_occlusion    the forward with the batch's statistics
  stats                            the running statistics after that
                                   training forward (flat, `stat_names`)
  <loss>_scalars                   one `jax.value_and_grad` of
                                   `trainer.tapir_loss_builder` ("tap":
                                   the loss and the position, occlusion and
                                   prob losses) and of
                                   `contrastive_loss_builder` ("contrastive":
                                   the loss twice), in SCALARS order
  <loss>_stats                     the running statistics after that step
  <loss>_norm, <loss>_ip           per gradient leaf (`leaf_names`), its L2
                                   norm and its inner product with a unit
                                   direction made from DIRECTION_SEED
  <loss>_heads                     the heads' gradients whole (flat)
  witness_<measure>                JAX's own distance from each of these when
                                   the video is nudged by NUDGE_REL (16
                                   float32 steps of 2^-23, a random sign per
                                   value, numpy seed NUDGE_SEED)
  f64_<measure>                    JAX's own distance from each of these when
                                   the same clip, weights and targets run in
                                   float64 (jax.enable_x64; the cost volume's
                                   einsum keeps its float32 output)

The backbone has 2.8 M parameters, so its gradients are held by
fingerprints, not leaf by leaf. Only results are stored
(tests/data/tapnet_golden.npz); the clip, the weights and the targets are
rebuilt from their seeds.

`judge` holds the port to the file, with limits derived here before any
port number was read. A float32 computation of the same function in
another order (cuDNN's or oneDNN's convolutions, another reduction order
in BatchNorm) moves the backbone's output by about 1e-5 of its size after
its 13 convolutions; the cost volume of unit vectors then moves by 1e-5,
the position logits by a few 1e-5, the heatmap's weights by ten times that
(the softmax temperature), and a soft-argmax over a 5-cell (40 px) radius
by 40 px times 3e-4:

  * tracks: TRACK_ATOL (0.02 px), or WITNESS_FACTOR x the witness on the
    queries it keeps, whichever is larger. A query whose track the nudge
    alone moves by more than NEAR_TIE_PX is a near tie (two heatmap peaks
    of nearly one height): it is listed and not held;
  * occlusion logits: LOGIT_ATOL (O(1) logits through the same path) or
    WITNESS_FACTOR x the witness;
  * the losses and scalars: LOSS_REL of each, or WITNESS_FACTOR x the
    witness;
  * the running statistics after the step: STATS_REL of the largest, or
    WITNESS_FACTOR x the witness (float32 means of 10^5-10^6 values);
  * per gradient leaf, its norm and its inner product with the unit
    direction: GRAD_REL of the leaf's norm plus GRAD_FLOOR of the model's
    largest |g|, plus WITNESS_FACTOR x the witness of that number (the
    forward's 3e-4 on the heatmaps' weights, through the soft-argmax's
    backward, reaches the gradients at up to ten times that); the heads'
    gradients element by element the same with the leaf's largest |g| for
    its norm.

On the card (`judge(card=True)`), every WITNESS_FACTOR x witness term
takes the larger of JAX's nudge witness and f64: JAX's float32 numbers'
distance from its own float64 ones is what float32 rounding at every layer
does to each number, where the nudge puts the noise in at the input only.
cuDNN's convolutions (TF32 off) round in another order than XLA's; the
card's distance from JAX is at most its own distance from the float64
numbers plus JAX's, about twice f64, inside the factor of 3. The two
differ most in the gradients: a ReLU input within float32 noise of zero
takes its gradient on one side only (tests/test_torch_tapnet.py's
value_and_grad), so the f64 fingerprints stand well above the nudge's.
Both witnesses are JAX's alone; no port number enters a limit.

  JAX_PLATFORMS=cpu python tools/make_tapnet_golden.py

numpy only at import: the port's tests and chip_smoke.py import
`golden_batch`, `run_port`, `judge` and the constants.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests/data/tapnet_golden.npz")
sys.path.insert(0, REPO)
from tools.golden_clip import make_clip  # noqa: E402
from tools.tapnet_weights import seeded_tapnet_params  # noqa: E402

WEIGHT_SEED, TARGET_SEED, DIRECTION_SEED = 0, 1, 2
NUDGE_REL, NUDGE_SEED = 16 * 2.0**-23, 3
CHUNK = 16
LOSSES = ("tap", "contrastive")
SCALARS = {"tap": ("loss", "position_loss", "occlusion_loss", "prob_loss"),
           "contrastive": ("loss", "contrastive_loss")}
WITNESS_FACTOR = 3.0
TRACK_ATOL, NEAR_TIE_PX = 0.02, 1.0
LOGIT_ATOL = 2e-4
LOSS_REL = 1e-4
STATS_REL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-7


class _Config:
  """TapNetConfig()'s fields (both packages' defaults)."""
  feature_grid_stride, num_heads, softmax_temperature, depth = 8, 1, 10.0, 18


def golden_batch() -> Dict[str, np.ndarray]:
  """The clip (float32 in [-1, 1]), its query points (t, y, x), and seed-made
  targets (x, y) and occlusion."""
  video, query_points = make_clip()
  frames = video.astype(np.float32) / 255.0 * 2.0 - 1.0
  t = frames.shape[1]
  rng = np.random.RandomState(TARGET_SEED)
  n = query_points.shape[1]
  velocity = rng.uniform(-4, 4, (n, 2))
  steps = np.arange(t)[None, :, None] - query_points[0, :, 0, None, None]
  target = query_points[0][:, None, [2, 1]] + velocity[:, None] * steps
  target = np.clip(target, 0, 255).astype(np.float32)
  occluded = (rng.rand(n, t) < 0.2).astype(np.float32)
  occluded[np.arange(n), query_points[0, :, 0].astype(int)] = 0.0
  return dict(video=frames, query_points=query_points,
              target_points=target[None], occluded=occluded[None])


def nudged_video(video: np.ndarray) -> np.ndarray:
  sign = np.random.RandomState(NUDGE_SEED).choice([-1.0, 1.0], video.shape)
  return (video * (1.0 + sign * NUDGE_REL)).astype(np.float32)


def _walk(tree, prefix=()):
  for key in sorted(tree):
    if isinstance(tree[key], Mapping):
      yield from _walk(tree[key], prefix + (key,))
    else:
      yield "/".join(prefix + (key,)), np.asarray(tree[key], np.float32)


def fingerprint(grads: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
  """Per leaf of a Flax-layout gradient tree, its L2 norm and its inner
  product with a seed-made unit direction; the heads' leaves whole."""
  names, norms, ips, heads = [], [], [], []
  for i, (name, g) in enumerate(_walk(grads)):
    d = np.random.default_rng([DIRECTION_SEED, i]).standard_normal(g.shape)
    d /= np.linalg.norm(d)
    names.append(name)
    norms.append(np.linalg.norm(g.astype(np.float64)))
    ips.append(float(np.sum(g.astype(np.float64) * d)))
    if name.startswith("heads/"):
      heads.append(g.ravel())
  return {"leaf_names": np.array(names), f"{prefix}_norm": np.array(norms),
          f"{prefix}_ip": np.array(ips),
          f"{prefix}_heads": np.concatenate(heads),
          f"{prefix}_gmax": np.array(max(np.abs(g).max() for _, g in
                                         _walk(grads)))}


def _flat_stats(stats, key) -> Dict[str, np.ndarray]:
  names, values = zip(*_walk(stats))
  return {"stat_names": np.array(names),
          key: np.concatenate([v.ravel() for v in values])}


def _results(forward, value_and_grad, batch) -> Dict[str, np.ndarray]:
  """Every golden number from one side: `forward(batch, is_training) ->
  (tracks, occlusion, stats tree or None)`, `value_and_grad(loss, batch) ->
  (scalars dict, Flax-layout grads, stats tree after the step)`."""
  out = {}
  for mode in ("eval", "train"):
    tracks, occ, stats = forward(batch, mode == "train")
    out[f"{mode}_tracks"], out[f"{mode}_occlusion"] = tracks, occ
    if stats is not None:
      out.update(_flat_stats(stats, "stats"))
  for loss in LOSSES:
    scalars, grads, stats = value_and_grad(loss, batch)
    out[f"{loss}_scalars"] = np.array([scalars[k] for k in SCALARS[loss]])
    out.update(_flat_stats(stats, f"{loss}_stats"))
    out.update(fingerprint(grads, loss))
  return out


def _witness(base, moved, prefix="witness") -> Dict[str, np.ndarray]:
  """`moved`'s distance from JAX's numbers: per query for the tracks
  (largest over frames), per number elsewhere."""
  w = {}
  for key, value in base.items():
    if (key in ("leaf_names", "stat_names") or key.endswith("_gmax")
        or key.startswith(("witness_", "f64_"))):
      continue
    diff = np.abs(np.asarray(moved[key], np.float64) - value)
    if key.endswith("_tracks"):
      diff = np.linalg.norm(moved[key] - value, axis=-1)[0].max(-1)
    w[f"{prefix}_{key}"] = diff
  return w


def judge(golden: Mapping[str, np.ndarray], port: Mapping[str, np.ndarray],
          card: bool = False) -> Dict[str, Any]:
  """The port's numbers (`run_port`) against the file; returns the
  readings, the limits and `ok`. `card`: the witness terms take JAX's
  float32-from-float64 distance too (the module docstring)."""
  f = WITNESS_FACTOR

  def witness(key):
    w = golden[f"witness_{key}"]
    return np.maximum(w, golden[f"f64_{key}"]) if card else w

  r: Dict[str, Any] = {"card_limits": card}
  ok = True
  for mode in ("eval", "train"):
    key = f"{mode}_tracks"
    near = np.nonzero(golden[f"witness_{key}"] > NEAR_TIE_PX)[0]
    keep = np.setdiff1d(np.arange(golden[key].shape[1]), near)
    err = np.linalg.norm(port[key] - golden[key], axis=-1)[0].max(-1)
    lim = max(TRACK_ATOL, f * float(witness(key)[keep].max()))
    occ_err = float(np.abs(port[f"{mode}_occlusion"]
                           - golden[f"{mode}_occlusion"]).max())
    occ_lim = max(LOGIT_ATOL, f * float(witness(f"{mode}_occlusion").max()))
    r[mode] = dict(track_max_px=float(err[keep].max()), track_limit_px=lim,
                   near_ties={int(q): float(err[q]) for q in near},
                   occlusion_max=occ_err, occlusion_limit=occ_lim)
    ok &= r[mode]["track_max_px"] <= lim and occ_err <= occ_lim
  for key in ("stats",) + tuple(f"{loss}_stats" for loss in LOSSES):
    stats_err = np.abs(port[key] - golden[key])
    stats_lim = np.maximum(STATS_REL * np.abs(golden[key]).max(),
                           f * witness(key))
    r[key] = dict(max_abs=float(stats_err.max()),
                  worst_over_limit=float((stats_err / stats_lim).max()))
    ok &= r[key]["worst_over_limit"] <= 1
  for loss in LOSSES:
    s_err = np.abs(port[f"{loss}_scalars"] - golden[f"{loss}_scalars"])
    s_lim = np.maximum(LOSS_REL * np.abs(golden[f"{loss}_scalars"]),
                       f * witness(f"{loss}_scalars"))
    s_lim = np.maximum(s_lim, np.finfo(np.float32).tiny)  # a loss of 0
    floor = GRAD_FLOOR * float(golden[f"{loss}_gmax"])
    norm = golden[f"{loss}_norm"]
    over = {}
    for what in ("norm", "ip"):
      err = np.abs(port[f"{loss}_{what}"] - golden[f"{loss}_{what}"])
      lim = GRAD_REL * norm + floor + f * witness(f"{loss}_{what}")
      over[what] = float((err / lim).max())
    h_err = np.abs(port[f"{loss}_heads"] - golden[f"{loss}_heads"])
    h_lim = (GRAD_REL * np.abs(golden[f"{loss}_heads"]).max() + floor
             + f * witness(f"{loss}_heads"))
    over["heads"] = float((h_err / h_lim).max())
    r[loss] = dict(scalars=dict(zip(SCALARS[loss],
                                    port[f"{loss}_scalars"].tolist())),
                   scalars_over_limit=float((s_err / s_lim).max()),
                   grads_over_limit=over)
    ok &= r[loss]["scalars_over_limit"] <= 1 and max(over.values()) <= 1
  r["ok"] = bool(ok)
  return r


def run_port(device="cpu") -> Dict[str, np.ndarray]:
  """The golden numbers from the port's TAPNet on `device` (torch)."""
  import torch

  from tapnet_tpu_torch.checkpoints import convert
  from tapnet_tpu_torch.models import tapnet
  from tapnet_tpu_torch.training import trainer

  params, stats = seeded_tapnet_params(_Config, WEIGHT_SEED)
  model = tapnet.TAPNet(tapnet.TapNetConfig()).to(device)
  task = trainer.TaskConfig(train_chunk_size=CHUNK)

  def forward(batch, is_training):
    convert.load_tapnet_params(model, params, stats)
    with torch.no_grad():
      out = model(batch["video"], batch["query_points"],
                  query_chunk_size=CHUNK, is_training=is_training)
    moved = (convert.stats_to_flax(dict(model.named_buffers()))
             if is_training else None)
    return (out["tracks"].cpu().numpy(), out["occlusion"].cpu().numpy(),
            moved)

  def value_and_grad(loss, batch):
    convert.load_tapnet_params(model, params, stats)
    builder = (trainer.tapir_loss_builder if loss == "tap"
               else trainer.contrastive_loss_builder)
    _, scalars, grads = trainer.loss_and_grads(
        builder(model, task), dict(model.named_parameters()), batch)
    return ({k: float(v) for k, v in scalars.items()},
            convert.state_dict_to_tapnet(grads),
            convert.stats_to_flax(dict(model.named_buffers())))

  batch = {k: torch.from_numpy(v).to(device)
           for k, v in golden_batch().items()}
  return _results(forward, value_and_grad, batch)


def main():
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu.models import tapnet
  from tapnet_tpu.training import trainer

  params, stats = seeded_tapnet_params(_Config, WEIGHT_SEED)
  model = tapnet.TAPNet(tapnet.TapNetConfig())
  task = trainer.TaskConfig(train_chunk_size=CHUNK)

  @jax.jit
  def apply(variables, video, query_points):
    return {mode: model.apply(
        variables, video, query_points, query_chunk_size=CHUNK,
        is_training=mode == "train", mutable=["batch_stats"])
        for mode in ("eval", "train")}

  grad_fns = {
      loss: jax.jit(jax.value_and_grad(builder(model, task), has_aux=True))
      for loss, builder in (("tap", trainer.tapir_loss_builder),
                            ("contrastive", trainer.contrastive_loss_builder))}

  def run(batch, dtype=np.float32):
    cast = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, dtype)), tree)
    p, s, jbatch = cast(params), cast(stats), cast(batch)
    outs = apply({"params": p, "batch_stats": s}, jbatch["video"],
                 jbatch["query_points"])
    outs = {mode: (np.asarray(o["tracks"]), np.asarray(o["occlusion"]),
                   o_state["batch_stats"] if mode == "train" else None)
            for mode, (o, o_state) in outs.items()}

    def value_and_grad(loss, _):
      (_, (scalars, moved)), grads = grad_fns[loss](
          p, {"batch_stats": s}, jbatch, jax.random.PRNGKey(0))
      return ({k: float(v) for k, v in scalars.items()},
              jax.tree_util.tree_map(np.asarray, grads),
              moved["batch_stats"])

    return _results(lambda _, training: outs["train" if training else "eval"],
                    value_and_grad, batch)

  batch = golden_batch()
  out = run(batch)
  print("ran the clip", flush=True)
  out.update(_witness(out, run(dict(batch, video=nudged_video(batch["video"])))))
  with jax.enable_x64(True):
    out.update(_witness(out, run(batch, np.float64), "f64"))
  print({k: float(np.max(v)) for k, v in out.items()
         if k.startswith(("witness", "f64"))})
  np.savez_compressed(OUT, **out)
  print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
  main()
