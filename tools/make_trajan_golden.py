"""Writes golden TRAJAN outputs of the JAX package for the PyTorch port, and
holds the port's to them.

Runs the JAX package's `TrackAutoEncoder()` at its published widths (150
frames, 128 latent tokens of 64, decoder width 1024) on the CPU with the
seed-made weights of tools/trajan_weights.py (seed WEIGHT_SEED) on
`golden_inputs()`: one clip of 64 support tracks over 150 frames (numpy
seed INPUT_SEED; smooth tracks, 10% of the samples hidden, track HIDDEN
never visible, `boundary_frame` BOUNDARY so frames 120-149 are padding)
and 64 query points (t, x, y), LATE of them at frames 154-199, where the
time window `_append_time_feat` starts at 5 t > 896 - 128 and JAX's
dynamic slice clamps it. The dither is JAX's draw for PRNGKey(0), which
`__call__` uses; the port cannot draw it, so the file stores it and the
port is fed it. Writes tests/data/trajan_golden.npz:

  noise [1, 128, 64]       the dither
  latents [1, 128, 64]     `encode` (before the clip and the quantization)
  tracks [1, 64, 150, 2], visible_logits, certain_logits [1, 64, 150, 1]
                           `__call__`, one pass
  witness_latents          JAX's own distance from `latents` when the
                           support tracks are nudged NUDGE_ULPS float32 ulps
  witness_<output>         JAX's own distance from the outputs of `decode`
                           on the golden latents when the decoder's query
                           embedding is nudged EMBED_NUDGE_ULPS ulp
  chaos_<output>           the same when the query (x, y) are nudged
                           NUDGE_ULPS ulps instead (a reading, not a limit)
  jit_<output>             the jitted `__call__`'s distance from the golden
                           outputs (a reading, not a limit)
  midpoint_distance        the least distance of the clipped latents x 128
                           from a rounding midpoint

JAX runs here op by op, without `jax.jit`: in the jitted program XLA
fuses the embedding's sine with its argument and computes it 6.1e-5 from
the exact sine of the float32 argument (float64 numpy), where XLA's sine
on its own and PyTorch's lie within 3.5e-8 of it (arguments up to 1290:
the embedding's top frequency is 2^(31/3)). The decoder's second embedding
(below) carries that to 2.6e-3 in the outputs, so the jitted program is a
reading of its own (`jit_<output>`: its distance from the golden outputs),
not the reference.

Why the decoder's witness nudges the embedding by one ulp and not the
query by 16: the decoder embeds the query's sinusoidal embedding a second
time, so a feature of the first (in [-1, 1]) is multiplied by up to
2^(31/3) = 1290 before its sine. 16 ulps of an (x, y) near 0.5 move the
first embedding by about 1e-3 and the second one's arguments by radians:
JAX's own outputs then move by 0.17 (chaos_tracks), the model's
sensitivity and not float32 noise. Both sines, XLA's and PyTorch's, lie
within half an ulp of the exact sine of their float32 argument, so one ulp
of the first embedding is the noise an implementation adds there.

`judge` holds the port to the file, with limits derived here before any
port number was read:

  * latents: LATENT_ATOL absolute (float32 sums in other orders through
    the 8 encoder layers whose outputs are O(1): 2^-23 x depth x a few) or
    WITNESS_FACTOR x the witness, whichever is larger;
  * `decode` on the golden latents and noise (the same quantization on
    both sides): every output within OUTPUT_ATOL (the decoder's 7 layers
    and a 1024-wide readout; outputs O(1)-O(10)) or WITNESS_FACTOR x the
    witness;
  * the whole `forward` (the port's own latents): the same output limits,
    when every latent rounds to the same 1/128 step as JAX's. JAX's
    latents lie as close as midpoint_distance / 128 to a rounding midpoint
    (8.0e-5 / 128 here), nearer than float32 noise may reach, so a latent
    may land on the other step: the forward's outputs then move by a
    step's worth and are reported, not held (the decode check above holds
    the decoder on JAX's own steps);
  * chunked decoding (`decoder_chunk_size=CHUNK`) against the port's one
    pass: OUTPUT_ATOL (the same latents and noise, products of other
    shapes).

  JAX_PLATFORMS=cpu python tools/make_trajan_golden.py

numpy only at import: the port's tests and chip_smoke.py import
`golden_inputs` (the port's example's `synthetic_tracks`, then the hidden
track and the queries from the same draw), `run_port`, `judge` and the
constants.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests/data/trajan_golden.npz")
sys.path.insert(0, REPO)
from tools.trajan_weights import seeded_trajan_params  # noqa: E402

WEIGHT_SEED, INPUT_SEED = 0, 0
TRACKS, FRAMES, QUERIES, LATE = 64, 150, 64, 8
HIDDEN, BOUNDARY, CHUNK = 3, 120, 16
NUDGE_ULPS = 16
EMBED_NUDGE_ULPS = 1
WITNESS_FACTOR = 3.0
LATENT_ATOL = 1e-5
OUTPUT_ATOL = 1e-4
OUTPUTS = ("tracks", "visible_logits", "certain_logits")


def golden_inputs() -> Dict[str, np.ndarray]:
  """The golden clip's TRAJAN inputs (numpy, batch 1)."""
  from tapnet_tpu_torch.examples.trajan_roundtrip import synthetic_tracks

  rng = np.random.RandomState(INPUT_SEED)
  tracks, visible = synthetic_tracks(TRACKS, FRAMES, rng=rng)
  visible[HIDDEN] = 0.0
  frames = np.concatenate([rng.randint(0, FRAMES, QUERIES - LATE),
                           rng.randint(154, 200, LATE)])
  xy = tracks[np.arange(QUERIES) % TRACKS, np.minimum(frames, FRAMES - 1)]
  query_points = np.concatenate([frames[:, None], xy], -1).astype(np.float32)
  return dict(support_tracks=tracks[None],
              support_tracks_visible=visible[None],
              boundary_frame=np.array([BOUNDARY], np.int32),
              query_points=query_points[None])


def nudged(values: np.ndarray, ulps: int = NUDGE_ULPS) -> np.ndarray:
  out = np.asarray(values, np.float32)
  for _ in range(ulps):
    out = np.nextafter(out, np.float32(np.inf)).astype(np.float32)
  return out


def midpoint_distance(latents: np.ndarray) -> np.ndarray:
  """|clip(latents) x 128 - the nearest rounding midpoint|, elementwise."""
  scaled = np.clip(latents, -1.0, 1.0) * 128.0
  return np.abs(scaled - np.floor(scaled) - 0.5)


def limits(golden: Mapping[str, np.ndarray]) -> Dict[str, float]:
  lim = {"latents": max(LATENT_ATOL,
                        WITNESS_FACTOR * float(golden["witness_latents"]))}
  for key in OUTPUTS:
    lim[key] = max(OUTPUT_ATOL, WITNESS_FACTOR * float(golden[f"witness_{key}"]))
  return lim


def _apart(a, b) -> float:
  return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def judge(golden: Mapping[str, np.ndarray], latents, decoded, forward,
          chunked) -> Dict[str, object]:
  """The port's numbers against the file. `latents`: the port's `encode`;
  `decoded`, `forward`, `chunked`: dicts of OUTPUTS (numpy) of `decode` on
  the golden latents and noise, of the one-pass `forward` and of the
  chunked one (both fed the noise). Returns the readings and `ok`."""
  lim = limits(golden)
  r = {"limits": lim, "latents": _apart(latents, golden["latents"])}
  r["decode"] = {k: _apart(decoded[k], golden[k]) for k in OUTPUTS}
  r["forward"] = {k: _apart(forward[k], golden[k]) for k in OUTPUTS}
  r["chunked_vs_one_pass"] = {k: _apart(chunked[k], forward[k])
                              for k in OUTPUTS}
  step = lambda x: np.round(np.clip(x, -1.0, 1.0) * 128.0)
  other_step = step(latents) != step(golden["latents"])
  r["latents_on_other_step"] = int(other_step.sum())
  ok = (r["latents"] <= lim["latents"]
        and all(r["decode"][k] <= lim[k] for k in OUTPUTS)
        and all(r["chunked_vs_one_pass"][k] <= OUTPUT_ATOL for k in OUTPUTS))
  if not other_step.any():
    ok = ok and all(r["forward"][k] <= lim[k] for k in OUTPUTS)
  r["ok"] = bool(ok)
  return r


def run_port(golden: Mapping[str, np.ndarray], device="cpu"):
  """The port's numbers for `judge`: (latents, decoded, forward, chunked)
  of the published-width model on `device` (torch), fed the golden dither
  and, for `decoded`, the golden latents."""
  import torch

  from tapnet_tpu_torch.checkpoints import convert
  from tapnet_tpu_torch.trajan import track_autoencoder

  model = track_autoencoder.TrackAutoEncoder()
  convert.load_trajan_params(model, seeded_trajan_params(WEIGHT_SEED))
  model = model.to(device)
  x = {k: torch.from_numpy(v).to(device) for k, v in golden_inputs().items()}
  noise = torch.from_numpy(golden["noise"]).to(device)
  pick = lambda r: {k: getattr(r, k).cpu().numpy() for k in OUTPUTS}
  with torch.no_grad():
    latents = model.encode(x).cpu().numpy()
    decoded = model.decode(torch.from_numpy(golden["latents"]).to(device),
                           model.get_decoder_context(x), noise=noise)
    forward = model(x, noise=noise)
    model.decoder_chunk_size = CHUNK
    chunked = model(x, noise=noise)
  return latents, pick(decoded), pick(forward), pick(chunked)


def main():
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu.trajan import track_autoencoder

  params = {"params": seeded_trajan_params(WEIGHT_SEED)}
  model = track_autoencoder.TrackAutoEncoder()
  inputs = golden_inputs()
  call = lambda x: model.apply(params, x)
  encode = lambda x: model.apply(params, x, method=model.encode)

  def decode(latents, x, embed_ulps=0):
    ctx = model.apply(params, x, method=model.get_decoder_context)
    query = ctx.decoder_query
    for _ in range(embed_ulps):
      query = jnp.nextafter(query, jnp.float32(jnp.inf))
    ctx = ctx.replace(decoder_query=query)
    return model.apply(params, latents, ctx, method=model.decode)

  res = call(inputs)
  latents = np.asarray(encode(inputs))
  out = dict(noise=np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                                 latents.shape)),
             latents=latents, midpoint_distance=midpoint_distance(latents).min())
  for key in OUTPUTS:
    out[key] = np.asarray(getattr(res, key))
  nudged_inputs = dict(inputs, support_tracks=nudged(inputs["support_tracks"]))
  out["witness_latents"] = _apart(encode(nudged_inputs), latents)
  qp = inputs["query_points"].copy()
  qp[..., 1:] = nudged(qp[..., 1:])
  chaos = decode(jnp.asarray(latents), dict(inputs, query_points=qp))
  moved = decode(jnp.asarray(latents), inputs, EMBED_NUDGE_ULPS)
  base = decode(jnp.asarray(latents), inputs)
  for key in OUTPUTS:
    out[f"witness_{key}"] = _apart(getattr(moved, key), getattr(base, key))
    out[f"chaos_{key}"] = _apart(getattr(chaos, key), getattr(base, key))
    out[f"jit_{key}"] = _apart(getattr(jax.jit(call)(inputs), key), out[key])
    print(key, "decode vs call", _apart(getattr(base, key), out[key]))
  print({k: v for k, v in out.items() if np.ndim(v) == 0}, flush=True)
  np.savez_compressed(OUT, **out)
  print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
  main()
