"""Visualizes the roll / homography video augmentations (port of
tapnet_tpu/data/augmentation_viz.py).

A synthetic clip carries a ground-truth track on a moving red dot; the
augmentation (`data.augmentations`, which warps the frames on `device`)
moves frames and track together, and the warped track is drawn back onto
the warped frames as a green ring, so the frames double as a check that
points are transformed consistently with pixels (the ring must stay on the
dot). `render` returns the frames; `write_gif` writes them (imageio).

  python -m tapnet_tpu_torch.data.augmentation_viz --mode roll \\
      --output_path /tmp/roll_viz.gif [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from tapnet_tpu_torch.data import augmentations


def make_dot_video(
    num_frames: int = 128, height: int = 256, width: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
  """A white clip with a red dot orbiting the center; returns
  (video [T, H, W, 3] uint8, tracks [T, 1, 2] (x, y)).

  The dot is pure red so it stays distinguishable from the black
  constant-fill that the warps introduce at the frame borders."""
  yy, xx = np.mgrid[0:height, 0:width]
  frames, tracks = [], []
  for i in range(num_frames):
    angle = 16 * np.pi * i / num_frames
    cx = width / 2 + 50 * np.cos(angle)
    cy = height / 2 + 50 * np.sin(angle)
    frame = np.full((height, width, 3), 255, np.uint8)
    dot = (yy - cy) ** 2 + (xx - cx) ** 2 <= 20**2
    frame[dot] = (255, 0, 0)
    # Corner labels (blue TL block / black BR block) to make flips obvious.
    frame[8:20, 8:20] = (0, 0, 255)
    frame[-20:-8, -20:-8] = 0
    frames.append(frame)
    tracks.append([[cx, cy]])
  return np.stack(frames), np.asarray(tracks, np.float32)


def draw_marker(
    frame: np.ndarray, xy: np.ndarray, radius: int = 4
) -> np.ndarray:
  """Draws a green ring at (x, y); out-of-frame points are skipped."""
  h, w = frame.shape[:2]
  x, y = float(xy[0]), float(xy[1])
  if not (0 <= x < w and 0 <= y < h):
    return frame
  yy, xx = np.mgrid[0:h, 0:w]
  d2 = (yy - y) ** 2 + (xx - x) ** 2
  ring = (d2 <= (radius + 1.5) ** 2) & (d2 >= (radius - 1.5) ** 2)
  frame = frame.copy()
  frame[ring] = (0, 200, 0)
  return frame


def is_red(pixel: np.ndarray) -> bool:
  """Whether an RGB uint8 pixel is the dot's red (within the roundings of a
  warp's interpolation)."""
  r, g, b = (int(v) for v in pixel)
  return r >= 200 and g <= 60 and b <= 60


def augment(mode: str, video: np.ndarray, tracks: np.ndarray,
            seed: Optional[int] = 0,
            device: Optional[Any] = None) -> Tuple[np.ndarray, np.ndarray]:
  """(warped video [T, H, W, 3] uint8, warped tracks [T, N, 2]) of one
  always-applied augmentation ("roll" or "homography") drawn from `seed`,
  the frames warped on `device` (None: the CUDA card)."""
  if mode == "roll":
    aug = augmentations.RollAugmentation(p=1.1, strength=1.0, seed=seed,
                                         device=device)
  elif mode == "homography":
    aug = augmentations.HomographyAugmentation(p=1.1, strength=1.0,
                                               seed=seed, device=device)
  else:
    raise ValueError(f"mode must be roll|homography, got {mode!r}")
  out = aug({"video": video.astype(np.float32), "tracks": tracks})
  return np.clip(out["video"], 0, 255).astype(np.uint8), out["tracks"]


def render(mode: str, num_frames: int = 128, seed: Optional[int] = 0,
           device: Optional[Any] = None) -> List[np.ndarray]:
  """The augmented dot clip with the warped track drawn on each frame."""
  video, tracks = make_dot_video(num_frames)
  warped, new_tracks = augment(mode, video, tracks, seed, device)
  return [draw_marker(warped[i], new_tracks[i, 0])
          for i in range(len(warped))]


def write_gif(frames: Sequence[np.ndarray], output_path: str,
              fps: int = 30) -> str:
  """Writes the frames as a looping GIF (imageio, imported here)."""
  import imageio

  imageio.mimsave(output_path, list(frames), fps=fps, loop=0)
  return output_path


def visualize(
    mode: str,
    output_path: str,
    num_frames: int = 128,
    seed: Optional[int] = 0,
    fps: int = 30,
    device: Optional[Any] = None,
) -> str:
  """Renders the augmented clip (with the warped track overlaid) to a GIF."""
  write_gif(render(mode, num_frames, seed, device), output_path, fps)
  print(f"Saved {mode} augmentation GIF to {output_path}")
  return output_path


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--mode", choices=["roll", "homography"],
                      default="roll")
  parser.add_argument("--output_path", default="/tmp/aug_viz.gif")
  parser.add_argument("--num_frames", type=int, default=128)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--device", default="cuda",
                      help="where the frames are warped (cuda or cpu)")
  args = parser.parse_args(argv)
  visualize(args.mode, args.output_path, args.num_frames, args.seed,
            device=args.device)


if __name__ == "__main__":
  main()
