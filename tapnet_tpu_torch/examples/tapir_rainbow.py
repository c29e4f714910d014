"""Rainbow visualization demo on the port: dense tracks with
motion-compensated tails (the counterpart of examples/tapir_rainbow.py).

Track a grid of points on a (foreground) frame, estimate per-frame camera
homographies from the tracks themselves (`utils.viz`'s RANSAC pipeline),
and render each point's full history as a tail that stays glued to the
scene while the camera moves.

  python -m tapnet_tpu_torch.examples.tapir_rainbow [--device cpu]
  python -m tapnet_tpu_torch.examples.tapir_rainbow --video clip.mp4 \\
      --checkpoint tapir_checkpoint_panning.npy
"""

from __future__ import annotations

import argparse

import numpy as np

from tapnet_tpu_torch import inference
from tapnet_tpu_torch.examples import _common
from tapnet_tpu_torch.models import tapir as tapir_lib
from tapnet_tpu_torch.utils import viz


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--video", default=None)
  p.add_argument("--checkpoint", default=None)
  p.add_argument("--resize", type=int, nargs=2, default=[256, 256])
  p.add_argument("--grid_stride", type=int, default=32)
  p.add_argument("--query_frame", type=int, default=0)
  p.add_argument("--num_frames", type=int, default=24,
                 help="synthetic clip length when no --video")
  p.add_argument("--tiny", action="store_true",
                 help="2-block model for quick smoke runs (random weights)")
  p.add_argument("--out", default="/tmp/tapir_rainbow.mp4")
  _common.add_device_flag(p)
  args = p.parse_args(argv)

  video_u8 = _common.load_video(
      args.video, num_frames=args.num_frames, resize=tuple(args.resize)
  )
  t, h, w = video_u8.shape[:3]
  config = tapir_lib.tapir_config()
  if args.tiny:
    config = _common.tiny_tapir(config)
  params = _common.tapir_params(args.checkpoint, config)

  predictor = inference.TapirPredictor(params, config=config,
                                       device=args.device)
  queries = _common.grid_queries(args.query_frame, h, w, args.grid_stride)
  out = predictor(_common.normalize_video(video_u8), queries)
  tracks = out["tracks"][0]  # [N, T, 2] (x, y)
  occluded = 1.0 - predictor.visibles(out)[0].astype(np.float32)

  print("estimating per-frame camera homographies from the tracks...")
  try:
    homogs, _, _ = viz.get_homographies_wrt_frame(
        tracks, occluded, (w, h), reference_frame=args.query_frame
    )
    # plot_tracks_tails inverts every homography: a singular one (the JAX
    # example does not check) is a failed estimate too.
    np.linalg.inv(homogs)
  except np.linalg.LinAlgError:
    # Degenerate tracks (e.g. random weights) — fall back to a static camera.
    print("homography estimation failed; assuming a static camera")
    homogs = np.broadcast_to(np.eye(3), (t, 3, 3)).copy()
  frames = viz.plot_tracks_tails(video_u8, tracks, occluded, homogs)
  viz.write_video(args.out, frames, fps=10)
  print(f"wrote {args.out}")
  return dict(tracks=tracks, occluded=occluded, homographies=homogs,
              painted=frames)


if __name__ == "__main__":
  main()
