"""TAP-Vid dataset generator: CSV annotations + videos -> sharded pickles
(port of tapnet_tpu/tapvid/generate.py: numpy and OpenCV, no torch).

Each CSV row is (youtube_id, start_sec, end_sec, then 250 x (x, y, occluded)
triplets with normalized coordinates). Videos are decoded at 25 fps and
re-encoded as JPEG byte lists (the readers in `tapvid.datasets` decode
them), grouped per clip, and written as
`tapvid_<name>_{i:04d}_of_{n:04d}.pkl`, which
`tapvid.datasets.create_kinetics_dataset` reads.

CLI:
  python -m tapnet_tpu_torch.tapvid.generate --csv_path annotations.csv \
      --video_root_path videos/ --output_base_path out/ [--num_shards 10]
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
from typing import Dict, Iterator, List, Tuple

import numpy as np

POINTS_PER_TRACK = 250
FRAMES_PER_CLIP = 250  # 10 seconds at 25 fps
FPS = 25.0


def find_videos(video_root_path: str) -> Dict[str, str]:
  """Maps '<youtube_id>_<start:06>_<end:06>' to the mp4 path (recursive)."""
  out: Dict[str, str] = {}
  for root, _, files in os.walk(video_root_path):
    for f in files:
      if f.endswith(".mp4"):
        out[f[:-4]] = os.path.join(root, f)
  return out


def read_annotations(
    csv_path: str,
) -> Dict[Tuple[str, int, int], List[np.ndarray]]:
  """Parses the CSV into {(id, start, end): [track arrays [250, 3]]}."""
  tracks: Dict[Tuple[str, int, int], List[np.ndarray]] = {}
  with open(csv_path) as f:
    for row in csv.reader(f):
      if len(row) != 3 + 3 * POINTS_PER_TRACK:
        raise ValueError(
            f"Expected {3 + 3 * POINTS_PER_TRACK} fields, got {len(row)}"
        )
      key = (row[0], int(row[1]), int(row[2]))
      pts = np.array(row[3:], np.float64).reshape(POINTS_PER_TRACK, 3)
      tracks.setdefault(key, []).append(pts)
  return tracks


def extract_frames_jpeg(
    video_path: str, fps: float = FPS, quality: int = 95
) -> List[bytes]:
  """Decode a video at `fps` and re-encode frames as JPEG bytes."""
  import cv2

  cap = cv2.VideoCapture(video_path)
  native_fps = cap.get(cv2.CAP_PROP_FPS) or fps
  step = native_fps / fps
  frames = []
  idx, next_keep = 0, 0.0
  while True:
    ok, frame = cap.read()
    if not ok:
      break
    if idx >= next_keep:
      ok2, buf = cv2.imencode(
          ".jpg", frame, [int(cv2.IMWRITE_JPEG_QUALITY), quality]
      )
      if not ok2:
        raise ValueError(f"JPEG encode failed for {video_path}")
      frames.append(buf.tobytes())
      next_keep += step
    idx += 1
  cap.release()
  return frames


def generate_example(
    video_path: str, tracks: List[np.ndarray]
) -> Dict[str, np.ndarray]:
  """One dataset example: JPEG frames + normalized points + occlusion."""
  frames = extract_frames_jpeg(video_path)
  if len(frames) < FRAMES_PER_CLIP:
    raise ValueError(
        f"{video_path}: got {len(frames)} frames, need {FRAMES_PER_CLIP}"
    )
  frames = frames[:FRAMES_PER_CLIP]
  arr = np.stack(tracks)  # [N, 250, 3]
  return {
      "video": np.array(frames, object),
      "points": arr[..., :2].astype(np.float32),
      "occluded": arr[..., 2].astype(bool),
  }


def generate_dataset(
    csv_path: str,
    video_root_path: str,
    output_base_path: str,
    dataset_name: str = "kinetics",
    num_shards: int = 10,
    verbose: bool = True,
) -> int:
  """Builds and writes the sharded pickle dataset. Returns #examples."""
  annotations = read_annotations(csv_path)
  videos = find_videos(video_root_path)

  examples = []
  for (vid, start, end), tracks in annotations.items():
    name = f"{vid}_{start:06}_{end:06}"
    if name not in videos:
      if verbose:
        print(f"missing video {name}; skipping")
      continue
    try:
      examples.append(generate_example(videos[name], tracks))
      if verbose:
        print(f"processed {name} ({len(tracks)} tracks)")
    except ValueError as e:
      if verbose:
        print(f"skipping {name}: {e}")

  os.makedirs(output_base_path, exist_ok=True)
  shards: List[List] = [[] for _ in range(num_shards)]
  for i, ex in enumerate(examples):
    shards[i % num_shards].append(ex)
  for i, shard in enumerate(shards):
    path = os.path.join(
        output_base_path,
        f"tapvid_{dataset_name}_{i:04d}_of_{num_shards:04d}.pkl",
    )
    with open(path, "wb") as f:
      pickle.dump(shard, f)
    if verbose:
      print(f"wrote {path} ({len(shard)} examples)")
  return len(examples)


def main():
  parser = argparse.ArgumentParser(description="TAP-Vid dataset generator")
  parser.add_argument("--csv_path", required=True)
  parser.add_argument("--video_root_path", required=True)
  parser.add_argument("--output_base_path", required=True)
  parser.add_argument("--dataset_name", default="kinetics")
  parser.add_argument("--num_shards", type=int, default=10)
  args = parser.parse_args()
  n = generate_dataset(
      args.csv_path,
      args.video_root_path,
      args.output_base_path,
      args.dataset_name,
      args.num_shards,
  )
  print(f"done: {n} examples")


if __name__ == "__main__":
  main()
