"""TAPNext tracking demo on the port, offline and streaming (the
counterpart of examples/tapnext_tracking.py).

Track points with the ViT-SSM model, either in one offline pass or
frame-by-frame with its recurrent state carried.

  python -m tapnet_tpu_torch.examples.tapnext_tracking [--device cpu]
  python -m tapnet_tpu_torch.examples.tapnext_tracking --video clip.mp4 \\
      --checkpoint bootstapnext_ckpt.npz --variant B --streaming
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tapnet_tpu_torch import inference
from tapnet_tpu_torch.examples import _common
from tapnet_tpu_torch.models import ssm_vit, tapnext


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--video", default=None)
  p.add_argument("--checkpoint", default=None)
  p.add_argument("--variant", default=None,
                 help="B for released checkpoints; default: tiny 'mu'")
  p.add_argument("--grid_stride", type=int, default=64)
  p.add_argument("--streaming", action="store_true")
  p.add_argument("--num_frames", type=int, default=24,
                 help="synthetic clip length when no --video")
  p.add_argument("--out", default="/tmp/tapnext_tracks.mp4")
  _common.add_device_flag(p)
  args = p.parse_args(argv)

  # TAPNext runs at its trained resolution (default 256x256).
  variant = args.variant or ("B" if args.checkpoint else "mu")
  config = ssm_vit.variant_config(variant)
  video_u8 = _common.load_video(
      args.video, num_frames=args.num_frames, resize=config.image_size
  )
  t, h, w = video_u8.shape[:3]
  video = _common.normalize_video(video_u8)
  queries = _common.grid_queries(0, h, w, args.grid_stride)

  if args.checkpoint and os.path.exists(args.checkpoint):
    from tapnet_tpu_torch.checkpoints import tapnext_checkpoint

    params = tapnext_checkpoint.load_tapnext_checkpoint(args.checkpoint)
  else:
    print("no checkpoint — RANDOM weights (pipeline demo only)")
    params = tapnext.init_tapnext_params(config,
                                         torch.Generator().manual_seed(0))

  if args.streaming:
    predictor = inference.OnlineTapnextPredictor(params, config=config,
                                                 device=args.device)
    tracks0, vis0 = predictor.init(video[:, :1], queries)
    all_tracks = [tracks0[0, :, 0]]  # [Q, 2] (y, x)
    all_visible = [vis0[0, :, 0, 0] > 0]
    for i in range(1, t):
      tr, vis = predictor.predict(video[:, i])
      all_tracks.append(tr[0])
      all_visible.append(vis[0])
    tracks = np.stack(all_tracks, axis=1)[..., ::-1]  # [Q, T, 2] (x, y)
    visibles = np.stack(all_visible, axis=1)
  else:
    predictor = inference.TapnextPredictor(params, config=config,
                                           device=args.device)
    out = predictor(video, queries)
    tracks = out["tracks"][0]
    visibles = out["occlusion"][0] < 0.0

  print(
      f"tracked {queries.shape[1]} points over {t} frames "
      f"({'streaming' if args.streaming else 'offline'}); "
      f"mean visibility {np.mean(visibles):.2f}"
  )
  painted = _common.save_tracks_video(args.out, video_u8, tracks, visibles)
  return dict(tracks=tracks, visibles=visibles, painted=painted)


if __name__ == "__main__":
  main()
