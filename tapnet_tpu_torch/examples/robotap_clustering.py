"""RoboTAP motion-clustering demo on the port: group dense tracks into rigid
objects (the counterpart of examples/robotap_clustering.py).

Densely track many points with causal TAPIR, then factorize the tracks into
rigidly-moving clusters (camera + objects) by optimizing low-rank projection
banks with split/merge search.

  python -m tapnet_tpu_torch.examples.robotap_clustering [--device cpu]
  python -m tapnet_tpu_torch.examples.robotap_clustering --video clip.mp4 \\
      --checkpoint causal_tapir_checkpoint.npy --num_points 512
"""

from __future__ import annotations

import argparse

import numpy as np

from tapnet_tpu_torch.examples import _common
from tapnet_tpu_torch.models import tapir as tapir_lib
from tapnet_tpu_torch.robotap import clustering, dense_tracking


def synthetic_rigid_tracks(num_points=60, num_frames=24, seed=0):
  """Two planted rigid groups: static background + a translating object."""
  rng = np.random.RandomState(seed)
  n_bg = num_points // 2
  bg = rng.rand(n_bg, 2) * 200 + 20
  obj = rng.rand(num_points - n_bg, 2) * 60 + 80
  t = np.arange(num_frames, dtype=np.float32)
  tracks = np.concatenate(
      [
          np.repeat(bg[:, None], num_frames, 1),
          obj[:, None] + np.stack([3 * t, 1.5 * t], -1)[None],
      ],
      axis=0,
  ).astype(np.float32)
  tracks += rng.randn(*tracks.shape).astype(np.float32) * 0.3
  visibility = np.ones(tracks.shape[:2], np.float32)
  return tracks, visibility


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--video", default=None)
  p.add_argument("--checkpoint", default=None)
  p.add_argument("--num_points", type=int, default=256)
  p.add_argument("--final_num_cats", type=int, default=4)
  p.add_argument("--iters_before_split", type=int, default=200)
  _common.add_device_flag(p)
  args = p.parse_args(argv)

  if args.video and args.checkpoint:
    video = _common.load_video(args.video, resize=(256, 256))
    config = tapir_lib.causal_tapir_config()
    params = _common.tapir_params(args.checkpoint, config)
    out = dense_tracking.track_many_points(
        video, params, config=config, num_points=args.num_points,
        device=args.device,
    )
    tracks, visibility = out["tracks"], out["visibility"]
    shape = video.shape
  else:
    print("no video/checkpoint — clustering planted synthetic rigid motion")
    tracks, visibility = synthetic_rigid_tracks()
    shape = (tracks.shape[1], 256, 256, 3)

  result = clustering.compute_clusters(
      {"demo": tracks},
      {"demo": visibility},
      ["demo"],
      {"demo": shape},
      final_num_cats=args.final_num_cats,
      max_num_cats=args.final_num_cats + 2,
      iters_before_split=args.iters_before_split,
      point_sample=min(2048, tracks.shape[0]),
      frame_sample=min(1024, tracks.shape[1]),
      verbose=False,
      device=args.device,
  )
  classes = result["classes"]
  uniq, counts = np.unique(classes, return_counts=True)
  print(f"clustered {tracks.shape[0]} tracks into {len(uniq)} motions:")
  for u, c in zip(uniq, counts):
    print(f"  cluster {u}: {c} points")
  return dict(tracks=tracks, classes=classes)


if __name__ == "__main__":
  main()
