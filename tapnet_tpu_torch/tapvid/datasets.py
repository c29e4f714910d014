"""TAP-Vid evaluation dataset readers and query samplers (the port's own copy
of tapnet_tpu/tapvid/datasets.py; numpy, with cv2, PIL and scipy imported
lazily where a reader needs them).

Behavioral parity: tapnet/tapvid/evaluation_datasets.py:230-683. Readers are
host-side generators yielding numpy dicts:
  video          [1, T, H, W, 3] float32 in [-1, 1]
  query_points   [1, Q, 3] (t, y, x) raster
  target_points  [1, Q, T, 2] (x, y) raster at video resolution
  occluded       [1, Q, T] bool

Video decode and resize run on the host with cv2 / PIL, imported only when a
video must be decoded or resized: the Kubric reader at its stored 256x256
needs neither, which is the path a machine without them takes. The resize
stays cv2's INTER_LINEAR (uint8 rounding with fixed-point weights), as the
JAX package's, so both packages read the same frames.

Note: the reference resizes with mediapy; cv2 INTER_LINEAR can shift
benchmark numbers by a hair. The reference's JHMDB reader has a bug
(undefined `gt_dir`, evaluation_datasets.py:345); here it is implemented
correctly from `jhmdb_path`.
"""

from __future__ import annotations

import csv
import glob
import io
import os
import pickle
from typing import Iterable, Mapping, Optional, Tuple

import numpy as np

DatasetElement = Mapping[str, Mapping[str, np.ndarray]]


def resize_video(video: np.ndarray, output_size: Tuple[int, int]) -> np.ndarray:
  """Resize [T, H, W, 3] uint8 video to (height, width) with cv2."""
  import cv2

  h, w = output_size
  return np.stack(
      [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in video]
  )


def _decode_frames(frames) -> np.ndarray:
  """Decode a list of JPEG byte strings (or pass arrays through)."""
  if isinstance(frames[0], bytes):
    from PIL import Image

    return np.stack(
        [np.array(Image.open(io.BytesIO(f))) for f in frames]
    )
  return np.asarray(frames)


def sample_queries_strided(
    target_occluded: np.ndarray,
    target_points: np.ndarray,
    frames: np.ndarray,
    query_stride: int = 5,
) -> Mapping[str, np.ndarray]:
  """Sample queries on every `query_stride`-th frame where tracks are visible.

  Args:
    target_occluded: [n, t] bool.
    target_points: [n, t, 2] (x, y) raster points.
    frames: [t, h, w, 3] video in [-1, 1].

  Returns:
    dict with batched video/query_points/target_points/occluded/trackgroup;
    each visible (track, sampled frame) pair becomes one query, ordered by
    frame then track (matching the reference's ordering).
  """
  n, t = target_occluded.shape
  queries, tracks, occs, groups = [], [], [], []
  track_ids = np.arange(n)
  for i in range(0, t, query_stride):
    mask = ~target_occluded[:, i].astype(bool)
    query = np.stack(
        [
            np.full(n, i, target_points.dtype),
            target_points[:, i, 1],
            target_points[:, i, 0],
        ],
        axis=-1,
    )
    queries.append(query[mask])
    tracks.append(target_points[mask])
    occs.append(target_occluded[mask])
    groups.append(track_ids[mask])

  return {
      "video": frames[None],
      "query_points": np.concatenate(queries, axis=0)[None],
      "target_points": np.concatenate(tracks, axis=0)[None],
      "occluded": np.concatenate(occs, axis=0)[None],
      "trackgroup": np.concatenate(groups, axis=0)[None],
  }


def sample_queries_first(
    target_occluded: np.ndarray,
    target_points: np.ndarray,
    frames: np.ndarray,
) -> Mapping[str, np.ndarray]:
  """One query per track: its first visible frame."""
  target_occluded = target_occluded.astype(bool)
  valid = (~target_occluded).sum(axis=1) > 0
  target_points = target_points[valid]
  target_occluded = target_occluded[valid]

  first_visible = np.argmax(~target_occluded, axis=1)  # [n]
  idx = np.arange(target_points.shape[0])
  xy = target_points[idx, first_visible]  # [n, 2] (x, y)
  query_points = np.stack(
      [first_visible.astype(xy.dtype), xy[:, 1], xy[:, 0]], axis=-1
  )

  return {
      "video": frames[None],
      "query_points": query_points[None],
      "target_points": target_points[None],
      "occluded": target_occluded[None],
  }


def _convert_example(
    frames: np.ndarray,
    target_points: np.ndarray,
    target_occ: np.ndarray,
    query_mode: str,
    resolution: Optional[Tuple[int, int]],
) -> Mapping[str, np.ndarray]:
  """Shared tail: resize, normalize, scale points, sample queries."""
  if resolution is not None and tuple(frames.shape[1:3]) != tuple(resolution):
    frames = resize_video(frames, tuple(resolution))
  frames = frames.astype(np.float32) / 255.0 * 2.0 - 1.0
  # Annotations are stored normalized to [0, 1]; scale to raster pixels.
  target_points = target_points * np.array(
      [frames.shape[2], frames.shape[1]]
  )
  if query_mode == "strided":
    return sample_queries_strided(target_occ, target_points, frames)
  elif query_mode == "first":
    return sample_queries_first(target_occ, target_points, frames)
  raise ValueError(f"Unknown query mode {query_mode!r}")


def create_davis_dataset(
    davis_points_path: str,
    query_mode: str = "strided",
    resolution: Optional[Tuple[int, int]] = (256, 256),
) -> Iterable[DatasetElement]:
  """TAP-Vid DAVIS: single pickle of {video_name: {video, points, occluded}}."""
  with open(davis_points_path, "rb") as f:
    data = pickle.load(f)
  for video_name in data:
    ex = data[video_name]
    yield {
        "davis": _convert_example(
            _decode_frames(ex["video"]),
            ex["points"],
            ex["occluded"],
            query_mode,
            resolution,
        )
    }


def create_kubric_dataset(
    data_dir: str,
    query_mode: str = "strided",
    train_size: Tuple[int, int] = (256, 256),
    max_dataset_size: Optional[int] = None,
) -> Iterable[DatasetElement]:
  """Kubric-format eval reader: held-out (or capped training) synthetic data.

  The reference evaluates on Kubric batches from its external TFDS pipeline
  (`create_kubric_eval_dataset` / `create_kubric_eval_train_dataset`,
  evaluation_datasets.py:441-487; capped at 100 examples for the train
  variant). This framework's Kubric format is a directory of npz files
  (`data.synthetic.export_npz` writes it): video uint8 [T, H, W, 3], target_points
  [N, T, 2] (x, y) raster at video resolution, occluded [N, T] bool.
  Files are read in sorted order so the eval set is deterministic; queries
  are resampled with the standard first/strided protocol (the reference's
  randomly-sampled training queries would make eval numbers noisy).
  """
  paths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
  if not paths:
    raise ValueError(f"No npz files in {data_dir}")
  if max_dataset_size is not None:
    paths = paths[:max_dataset_size]
  for path in paths:
    with np.load(path) as z:
      frames = z["video"]
      target_points = z["target_points"].astype(np.float32)
      occluded = z["occluded"]
    src_hw = frames.shape[1:3]
    if tuple(src_hw) != tuple(train_size):
      frames = resize_video(frames, tuple(train_size))
    frames = frames.astype(np.float32) / 255.0 * 2.0 - 1.0
    # npz points are raster at the stored video resolution (not the
    # normalized [0, 1] convention of the pickle benchmarks).
    target_points = target_points * np.array(
        [train_size[1] / src_hw[1], train_size[0] / src_hw[0]],
        dtype=np.float32,
    )
    if query_mode == "strided":
      example = sample_queries_strided(occluded, target_points, frames)
    elif query_mode == "first":
      example = sample_queries_first(occluded, target_points, frames)
    else:
      raise ValueError(f"Unknown query mode {query_mode!r}")
    yield {"kubric": example}


def create_rgb_stacking_dataset(
    robotics_points_path: str,
    query_mode: str = "strided",
    resolution: Optional[Tuple[int, int]] = (256, 256),
) -> Iterable[DatasetElement]:
  """TAP-Vid RGB-stacking: single pickle containing a list of examples."""
  with open(robotics_points_path, "rb") as f:
    data = pickle.load(f)
  for ex in data:
    yield {
        "robotics": _convert_example(
            _decode_frames(ex["video"]),
            ex["points"],
            ex["occluded"],
            query_mode,
            resolution,
        )
    }


def create_kinetics_dataset(
    kinetics_path: str,
    query_mode: str = "strided",
    resolution: Optional[Tuple[int, int]] = (256, 256),
) -> Iterable[DatasetElement]:
  """TAP-Vid Kinetics: sharded pickles (*_of_NNNN.pkl), JPEG-byte frames."""
  shards = sorted(
      glob.glob(os.path.join(kinetics_path, "*_of_[0-9]*.pkl"))
  )
  for shard in shards:
    with open(shard, "rb") as f:
      data = pickle.load(f)
    if isinstance(data, dict):
      data = list(data.values())
    for ex in data:
      yield {
          "kinetics": _convert_example(
              _decode_frames(ex["video"]),
              ex["points"],
              ex["occluded"],
              query_mode,
              resolution,
          )
      }


def read_video_file(video_path: str) -> np.ndarray:
  """Read an mp4 into [T, H, W, 3] uint8 RGB frames via OpenCV."""
  import cv2

  cap = cv2.VideoCapture(video_path)
  frames = []
  while True:
    ok, frame = cap.read()
    if not ok:
      break
    frames.append(frame[..., ::-1])  # BGR -> RGB
  cap.release()
  if not frames:
    raise ValueError(f"Could not read any frames from {video_path}")
  return np.stack(frames)


def create_csv_dataset(
    dataset_name: str,
    csv_path: str,
    video_base_path: str,
    query_mode: str = "strided",
    resolution: Optional[Tuple[int, int]] = (256, 256),
    max_video_frames: Optional[int] = 1000,
) -> Iterable[DatasetElement]:
  """CSV-annotated datasets (RoboTAP, Perception Test).

  Each CSV row: video_id, then a flat (t*3) list of normalized x, y, occluded
  triplets per frame. Videos longer than `max_video_frames` are split into
  roughly equal segments (matching the reference's eval protocol).
  """
  point_tracks_all = {}
  with open(csv_path, "r") as f:
    for row in csv.reader(f):
      video_id = row[0]
      point_tracks_all.setdefault(video_id, []).append(
          np.array(row[1:]).reshape(-1, 3)
      )

  for video_id, tracks_list in point_tracks_all.items():
    name = video_id if video_id.endswith(".mp4") else video_id + ".mp4"
    frames = read_video_file(os.path.join(video_base_path, name))

    point_tracks = np.stack(tracks_list, axis=0).astype(np.float32)
    if frames.shape[0] < point_tracks.shape[1]:
      point_tracks = point_tracks[:, : frames.shape[0]]
    points, occluded = point_tracks[..., :2], point_tracks[..., 2] > 0

    num_splits = int(np.ceil(frames.shape[0] / max_video_frames))
    for i in range(num_splits):
      start = i * frames.shape[0] // num_splits
      end = (i + 1) * frames.shape[0] // num_splits
      yield {
          dataset_name: _convert_example(
              frames[start:end],
              points[:, start:end],
              occluded[:, start:end],
              query_mode,
              resolution,
          )
      }


def create_jhmdb_dataset(
    jhmdb_path: str, resolution: Optional[Tuple[int, int]] = (256, 256)
) -> Iterable[DatasetElement]:
  """JHMDB pose tracks for PCK evaluation.

  Layout: <jhmdb_path>/splits/*_test_split1.txt lists videos (traintest==2),
  joints under joint_positions/<video>/joint_positions.mat, frames under
  Rename_Images/<video>/*.png.
  """
  import scipy.io as sio
  from PIL import Image

  videos = []
  for file in sorted(os.listdir(os.path.join(jhmdb_path, "splits"))):
    if not file.endswith("split1.txt"):
      continue
    video_folder = "_".join(file.split("_")[:-2])
    with open(os.path.join(jhmdb_path, "splits", file)) as f:
      for line in f:
        video, traintest = line.split()
        if int(traintest) == 2:
          videos.append(os.path.join(video_folder, video.split(".")[0]))

  if not videos:
    raise ValueError(f"No JHMDB videos found under {jhmdb_path}")

  for video in videos:
    joints = os.path.join(
        jhmdb_path, "joint_positions", video, "joint_positions.mat"
    )
    if not os.path.exists(joints):
      continue
    gt_pose = sio.loadmat(joints)["pos_img"]
    gt_pose = np.transpose(gt_pose, [1, 2, 0])  # [joints, frames, 2] (x, y)

    frame_files = sorted(
        glob.glob(os.path.join(jhmdb_path, "Rename_Images", video, "*.png"))
    )
    frames = np.stack(
        [np.array(Image.open(f).convert("RGB")) for f in frame_files]
    )
    height, width = frames.shape[1:3]

    # Joints outside the first frame are invalid for the whole track.
    invalid = (
        (gt_pose[:, 0:1, 0] < 0)
        | (gt_pose[:, 0:1, 0] >= width)
        | (gt_pose[:, 0:1, 1] < 0)
        | (gt_pose[:, 0:1, 1] >= height)
    )
    invalid = np.tile(invalid, [1, gt_pose.shape[1]])[..., None].astype(
        np.float32
    )
    gt_pose_orig = gt_pose

    if resolution is not None and tuple(frames.shape[1:3]) != tuple(
        resolution
    ):
      frames = resize_video(frames, tuple(resolution))
    frames = frames.astype(np.float32) / 255.0 * 2.0 - 1.0

    queries = gt_pose[:, 0]
    queries = np.concatenate(
        [queries[..., 0:1] * 0, queries[..., ::-1]], axis=-1
    )  # (t=0, y, x)
    gt_pose = gt_pose * np.array(
        [frames.shape[2] / width, frames.shape[1] / height]
    )
    gt_pose = (1.0 - invalid) * gt_pose + invalid * (-1.0)

    if gt_pose.shape[1] < frames.shape[0]:
      frames = frames[: gt_pose.shape[1]]

    yield {
        "jhmdb": {
            "video": frames[None],
            "query_points": queries[None],
            "target_points": gt_pose[None],
            "gt_pose": gt_pose[None],
            "gt_pose_orig": gt_pose_orig[None],
            "occluded": np.zeros(gt_pose.shape[:2], bool)[None],
            "fname": video,
            "im_size": np.array([height, width]),
        }
    }
