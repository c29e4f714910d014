"""Offline TAPIR/BootsTAPIR tracking demo on the port (the counterpart of
examples/tapir_offline.py).

Load a video, place a grid of query points on the first frame, run the
offline model once over the whole clip, and write a painted-track video.

  python -m tapnet_tpu_torch.examples.tapir_offline [--device cpu]
  python -m tapnet_tpu_torch.examples.tapir_offline --video clip.mp4 \\
      --checkpoint bootstapir_checkpoint_v2.npy --model bootstapir \\
      --bfloat16 --out tracks.mp4
"""

from __future__ import annotations

import argparse

from tapnet_tpu_torch import inference
from tapnet_tpu_torch.examples import _common
from tapnet_tpu_torch.models import tapir as tapir_lib

CONFIGS = {
    "tapir": tapir_lib.tapir_config,
    "bootstapir": tapir_lib.bootstapir_config,
}


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--video", default=None)
  p.add_argument("--checkpoint", default=None)
  p.add_argument("--model", default="tapir", choices=sorted(CONFIGS))
  p.add_argument("--resize", type=int, nargs=2, default=[256, 256])
  p.add_argument("--grid_stride", type=int, default=32)
  p.add_argument("--bfloat16", action="store_true")
  p.add_argument("--num_frames", type=int, default=24,
                 help="synthetic clip length when no --video")
  p.add_argument("--tiny", action="store_true",
                 help="2-block model for quick smoke runs (random weights)")
  p.add_argument("--out", default="/tmp/tapir_tracks.mp4")
  _common.add_device_flag(p)
  args = p.parse_args(argv)

  video_u8 = _common.load_video(
      args.video, num_frames=args.num_frames, resize=tuple(args.resize)
  )
  t = video_u8.shape[0]
  h, w = video_u8.shape[1:3]
  config = CONFIGS[args.model]()
  if args.tiny:
    config = _common.tiny_tapir(config)
  params = _common.tapir_params(args.checkpoint, config)

  predictor = inference.TapirPredictor(
      params, config=config, bfloat16=args.bfloat16, device=args.device
  )
  queries = _common.grid_queries(0, h, w, args.grid_stride)
  out = predictor(_common.normalize_video(video_u8), queries)
  visibles = predictor.visibles(out)

  print(
      f"tracked {queries.shape[1]} points over {t} frames; "
      f"mean visibility {visibles.mean():.2f}"
  )
  painted = _common.save_tracks_video(
      args.out, video_u8, out["tracks"][0], visibles[0]
  )
  return dict(tracks=out["tracks"][0], visibles=visibles[0], painted=painted)


if __name__ == "__main__":
  main()
