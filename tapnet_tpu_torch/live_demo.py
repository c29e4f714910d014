"""Interactive online TAPIR demo on the port: webcam (or video file) point
tracking (the counterpart of tapnet_tpu/live_demo.py).

Behavioral parity: tapnet/live_demo.py -- per-frame causal TAPIR with
click-to-track: clicking adds a query point into a ring buffer of slots,
resetting that slot's streaming state. `OnlineTapirPredictor` runs on the
CUDA card unless given `--device cpu`; its streaming state stays on the
device. cv2 (capture, window, drawing) is imported when the demo runs.

Usage:
  python -m tapnet_tpu_torch.live_demo --checkpoint causal_tapir.npy \\
      [--camera 0 | --video clip.mp4] [--resolution 256] [--no_display] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run_demo(
    predictor,
    capture,
    resolution: int = 256,
    num_slots: int = 8,
    display: bool = True,
):
  """Main loop. `predictor` is an OnlineTapirPredictor; `capture` yields BGR
  frames (cv2.VideoCapture-compatible). Returns the mean throughput of the
  last 50 steps in frames a second."""
  import cv2

  pos = []

  def mouse_click(event, x, y, flags, param):
    del flags, param
    if event == cv2.EVENT_LBUTTONDOWN:
      pos.append((y, x))

  if display:
    cv2.namedWindow("Point Tracking")
    cv2.setMouseCallback("Point Tracking", mouse_click)

  ok, frame = capture.read()
  if not ok:
    raise ValueError("Could not read a frame from the capture source.")
  frame = cv2.resize(frame, (resolution, resolution))
  rgb = frame[..., ::-1].astype(np.float32) / 255.0 * 2.0 - 1.0

  # Initialize all slots at the frame center; mark them inactive.
  query_points = np.full((1, num_slots, 3), resolution / 2, np.float32)
  query_points[..., 0] = 0.0
  predictor.init(rgb[None], query_points)
  active = np.zeros(num_slots, bool)
  next_slot = 0

  step_times = []
  while True:
    ok, frame = capture.read()
    if not ok:
      break
    frame = cv2.resize(frame, (resolution, resolution))
    rgb = frame[..., ::-1].astype(np.float32) / 255.0 * 2.0 - 1.0

    if pos:
      y, x = pos.pop(0)
      predictor.add_points(
          rgb[None], np.array([[[0.0, y, x]]], np.float32), [next_slot]
      )
      active[next_slot] = True
      next_slot = (next_slot + 1) % num_slots

    t0 = time.time()
    tracks, visibles = predictor.predict(rgb[None])
    step_times.append(time.time() - t0)
    if len(step_times) > 50:
      step_times.pop(0)

    if display:
      for i in range(num_slots):
        if active[i] and visibles[0, i]:
          x, y = int(tracks[0, i, 0]), int(tracks[0, i, 1])
          cv2.circle(frame, (x, y), 5, (255, 0, 0), -1)
      fps = 1.0 / max(np.mean(step_times), 1e-6)
      cv2.putText(
          frame,
          f"{fps:.1f} fps",
          (10, 20),
          cv2.FONT_HERSHEY_SIMPLEX,
          0.5,
          (0, 255, 0),
          1,
      )
      cv2.imshow("Point Tracking", frame)
      if cv2.waitKey(1) & 0xFF == ord("q"):
        break
  return 1.0 / max(np.mean(step_times), 1e-6) if step_times else 0.0


def main(argv=None):
  parser = argparse.ArgumentParser(description="Online TAPIR live demo")
  parser.add_argument("--checkpoint", required=True)
  parser.add_argument("--camera", type=int, default=0)
  parser.add_argument("--video", default=None,
                      help="track a video file instead of the webcam")
  parser.add_argument("--resolution", type=int, default=256)
  parser.add_argument("--num_slots", type=int, default=8)
  parser.add_argument("--no_display", action="store_true")
  parser.add_argument(
      "--model", choices=["causal_tapir", "causal_bootstapir"],
      default="causal_tapir",
  )
  parser.add_argument("--device", default="cuda",
                      help="torch device (default the CUDA card)")
  args = parser.parse_args(argv)

  import cv2

  from tapnet_tpu_torch import inference
  from tapnet_tpu_torch.checkpoints import tapir_checkpoint
  from tapnet_tpu_torch.models import tapir as tapir_lib

  config = getattr(tapir_lib, f"{args.model}_config")()
  params = tapir_checkpoint.load_tapir_checkpoint(args.checkpoint)
  predictor = inference.OnlineTapirPredictor(params, config,
                                             device=args.device)

  capture = cv2.VideoCapture(
      args.video if args.video is not None else args.camera
  )
  fps = run_demo(
      predictor,
      capture,
      resolution=args.resolution,
      num_slots=args.num_slots,
      display=not args.no_display,
  )
  capture.release()
  print(f"mean throughput: {fps:.2f} fps")
  return fps


if __name__ == "__main__":
  main()
