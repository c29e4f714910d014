"""How reliably a cut clustering schedule recovers planted rigid groups.

Runs RoboTAP's `compute_clusters` (default widths) on chip_smoke.py's
planted rigid tracks (robotap-cluster's input: 1024 tracks x 100 frames in
four 4-DoF groups, interleaved in one region at the first frame) for each
`iters_before_split` and seed, and prints one JSON line a run: seconds, ms a step, each recovered cluster's purity (the
share of its points from its main planted group), the groups that are no
cluster's majority, and the cluster sizes. The port draws from
`clustering.GeneratorDraws(seed, device)`; with `--jax` the JAX package's
`compute_clusters` runs instead, on the CPU, from its own PRNGKey(42)
(seeds do not apply; about half an hour a run at 100). `--layout carried`
plants harder data instead: two pairs of groups, each pair drawn from one
image region and carried by one translation throughout, its two groups
apart only by their own smaller translation, rotation and depth.

  python3 tools/robotap_cluster_seeds.py [--iters 60,100] [--seeds 42,0,1,2]
      [--device cuda] [--layout leave|carried]
  JAX_PLATFORMS=cpu python tools/robotap_cluster_seeds.py --jax --iters 100
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def carried_pairs_tracks(n=1024, t=100, groups=4, res=256, seed=0):
  """chip_smoke.planted_rigid_tracks' groups, paired: each pair's points
  drawn from one region (left or right of the centre) and carried by one
  translation; each group adds its own smaller translation, rotation and
  depth. Same noise and occlusion."""
  import chip_smoke

  rng = np.random.RandomState(seed)
  group = np.arange(n) % groups
  local = rng.uniform(-0.12, 0.12, (n, 2))
  ts = np.arange(t) / t
  smooth = lambda amp: sum(a * np.sin(2 * np.pi * f * ts + p) for a, f, p in
                           zip(rng.uniform(0, amp, 3), rng.uniform(0.3, 1.5, 3),
                               rng.uniform(0, 2 * np.pi, 3)))
  pairs = (groups + 1) // 2
  centres = np.linspace(-0.3, 0.3, pairs)
  carried = [(smooth(0.3), smooth(0.3)) for _ in range(pairs)]
  tracks = np.zeros((n, t, 2))
  for g in range(groups):
    sel = group == g
    (px, py) = carried[g // 2]
    angle, tx, ty = smooth(0.2), px + smooth(0.1), py + smooth(0.1)
    depth = 2.0 + smooth(0.1)
    cos, sin = np.cos(angle), np.sin(angle)
    x = local[sel, 0:1] * cos - local[sel, 1:2] * sin + centres[g // 2] + tx
    y = local[sel, 0:1] * sin + local[sel, 1:2] * cos + ty
    tracks[sel] = np.stack([x, y], -1) * res / depth[None, :, None] + res / 2
  tracks += rng.randn(*tracks.shape) * chip_smoke.CLUSTER_NOISE_PX
  vis = (rng.rand(n, t) > chip_smoke.CLUSTER_OCCLUDED).astype(np.float32)
  return tracks.astype(np.float32), vis, group


def run(iters, seed, device, use_jax, layout="leave"):
  import chip_smoke

  tracks, vis, group = (chip_smoke.planted_rigid_tracks() if layout == "leave"
                        else carried_pairs_tracks())
  args = ({"demo": tracks}, {"demo": vis}, ["demo"],
          {"demo": (tracks.shape[1], chip_smoke.TN_RES, chip_smoke.TN_RES, 3)})
  start = time.perf_counter()
  if use_jax:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tapnet_tpu.robotap import clustering as jax_clustering

    out = jax_clustering.compute_clusters(*args, iters_before_split=iters,
                                          verbose=False)
    steps = (25 + 10 - 1) * iters
  else:
    import torch

    from tapnet_tpu_torch.robotap import clustering

    out = clustering.compute_clusters(
        *args, iters_before_split=iters, verbose=False, device=device,
        draws=clustering.GeneratorDraws(seed, torch.device(device)))
    steps = out["num_steps"]
  seconds = time.perf_counter() - start
  classes = out["classes"]
  purity, absent = chip_smoke.cluster_purity(classes, group)
  return dict(jax=use_jax, layout=layout, iters=iters,
              seed=None if use_jax else seed,
              s=seconds, ms_per_step=seconds * 1e3 / steps,
              min_purity=min(purity.values()), purity=purity, absent=absent,
              sizes={int(c): int((classes == c).sum())
                     for c in np.unique(classes)})


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--iters", default="100")
  parser.add_argument("--seeds", default="42,0,1,2")
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--jax", action="store_true")
  parser.add_argument("--layout", default="leave", choices=("leave", "carried"))
  args = parser.parse_args(argv)
  seeds = [0] if args.jax else [int(s) for s in args.seeds.split(",")]
  for iters in (int(i) for i in args.iters.split(",")):
    for seed in seeds:
      print(json.dumps(run(iters, seed, args.device, args.jax, args.layout)),
            flush=True)


if __name__ == "__main__":
  sys.path.insert(0, REPO)
  main()
