"""Streaming (causal) TAPIR demo on the port: one step per frame (the
counterpart of examples/tapir_online.py).

Initialize query features from the first frame, then feed frames one at a
time through the causal model, carrying its streaming state -- the same
loop a webcam/robotics consumer runs (tapnet_tpu_torch/live_demo.py is the
interactive version).

  python -m tapnet_tpu_torch.examples.tapir_online [--device cpu]
  python -m tapnet_tpu_torch.examples.tapir_online --video clip.mp4 \\
      --checkpoint causal_bootstapir_checkpoint.npy --model causal_bootstapir
"""

from __future__ import annotations

import argparse

import numpy as np

from tapnet_tpu_torch import inference
from tapnet_tpu_torch.examples import _common
from tapnet_tpu_torch.models import tapir as tapir_lib

CONFIGS = {
    "causal_tapir": tapir_lib.causal_tapir_config,
    "causal_bootstapir": tapir_lib.causal_bootstapir_config,
}


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--video", default=None)
  p.add_argument("--checkpoint", default=None)
  p.add_argument(
      "--model", default="causal_tapir", choices=sorted(CONFIGS)
  )
  p.add_argument("--resize", type=int, nargs=2, default=[256, 256])
  p.add_argument("--grid_stride", type=int, default=64)
  p.add_argument("--num_frames", type=int, default=24,
                 help="synthetic clip length when no --video")
  p.add_argument("--tiny", action="store_true",
                 help="2-block model for quick smoke runs (random weights)")
  p.add_argument("--out", default="/tmp/tapir_online_tracks.mp4")
  _common.add_device_flag(p)
  args = p.parse_args(argv)

  video_u8 = _common.load_video(
      args.video, num_frames=args.num_frames, resize=tuple(args.resize)
  )
  t, h, w = video_u8.shape[:3]
  config = CONFIGS[args.model]()
  if args.tiny:
    config = _common.tiny_tapir(config)
  params = _common.tapir_params(args.checkpoint, config)
  video = _common.normalize_video(video_u8)

  predictor = inference.OnlineTapirPredictor(params, config=config,
                                             device=args.device)
  queries = _common.grid_queries(0, h, w, args.grid_stride)
  predictor.init(video[:, :1], queries)

  all_tracks, all_visible = [], []
  for i in range(t):
    tracks, visibles = predictor.predict(video[:, i])
    all_tracks.append(tracks[0])  # [N, 2]
    all_visible.append(visibles[0])
  tracks = np.stack(all_tracks, axis=1)  # [N, T, 2]
  visibles = np.stack(all_visible, axis=1)

  print(
      f"streamed {t} frames x {queries.shape[1]} points; "
      f"mean visibility {visibles.mean():.2f}"
  )
  painted = _common.save_tracks_video(args.out, video_u8, tracks, visibles)
  return dict(tracks=tracks, visibles=visibles, painted=painted)


if __name__ == "__main__":
  main()
