"""Flow-assisted track annotation demo on the port (the counterpart of
examples/flow_track_assist.py).

Given dense optical flow and two endpoint clicks, recover the in-between
trajectory with the dynamic-programming interpolator
(`tapnet_tpu_torch/utils/flow_track_assist.py`, on the device). With
torchvision available and `--video` given, flow comes from RAFT; otherwise
a synthetic flow field demonstrates the algorithm.

  python -m tapnet_tpu_torch.examples.flow_track_assist [--device cpu]
  python -m tapnet_tpu_torch.examples.flow_track_assist --video clip.mp4 \\
      --start 100 200 --end 180 160 --radius 20
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tapnet_tpu_torch.examples import _common
from tapnet_tpu_torch.utils import flow_track_assist


def raft_flow(video_u8, device):
  """Dense flow via torchvision RAFT (optional dependency path)."""
  from torchvision.models.optical_flow import (
      Raft_Large_Weights, raft_large,
  )

  model = raft_large(weights=Raft_Large_Weights.DEFAULT).eval().to(device)
  flows = []
  with torch.no_grad():
    for i in range(video_u8.shape[0] - 1):
      pair = [
          torch.tensor(
              video_u8[j].astype(np.float32).transpose(2, 0, 1)[None]
              / 127.5 - 1.0
          ).to(device)
          for j in (i, i + 1)
      ]
      flow = model(*pair)[-1][0].cpu().numpy().transpose(1, 2, 0)
      flows.append(flow)
  return np.stack(flows)


def synthetic_rotating_flow(t=12, h=64, w=64):
  """Flow of a slow rotation about the image center."""
  ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
  cy, cx = h / 2, w / 2
  omega = 0.05
  fx = -omega * (ys - cy)
  fy = omega * (xs - cx)
  return np.broadcast_to(
      np.stack([fx, fy], -1)[None], (t, h, w, 2)
  ).astype(np.float32)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--video", default=None)
  p.add_argument("--start", type=float, nargs=2, default=None,
                 help="(x, y) at the first frame")
  p.add_argument("--end", type=float, nargs=2, default=None,
                 help="(x, y) at the last frame")
  p.add_argument("--radius", type=int, default=8)
  _common.add_device_flag(p)
  args = p.parse_args(argv)

  if args.video:
    video = _common.load_video(args.video, resize=(256, 256))
    flows = raft_flow(video, args.device)
  else:
    print("no video — using a synthetic rotating flow field")
    flows = synthetic_rotating_flow()

  h, w = flows.shape[1:3]
  start = tuple(args.start) if args.start else (w * 0.75, h * 0.5)
  # Default end: where plain flow chaining lands (then DP refines the path).
  chained = flow_track_assist.chain_flow(flows, start)
  end = tuple(args.end) if args.end else tuple(chained[-1])

  track = flow_track_assist.interpolate_track(
      flows, start, end, radius=args.radius, device=args.device
  )
  drift = np.linalg.norm(track - chained, axis=-1)
  print(f"interpolated {track.shape[0]}-frame track {start} -> {end}")
  print(f"max deviation from naive chaining: {drift.max():.2f} px")
  for t_i in range(0, track.shape[0], max(1, track.shape[0] // 6)):
    print(f"  frame {t_i:3d}: ({track[t_i, 0]:6.1f}, {track[t_i, 1]:6.1f})")
  return dict(track=track, chained=chained)


if __name__ == "__main__":
  main()
