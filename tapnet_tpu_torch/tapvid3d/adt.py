"""ADT (Aria Digital Twin) annotation computation for TAPVid-3D (the port's
own copy of tapnet_tpu/tapvid3d/adt.py; numpy and PIL).

The released ADT npz files on GCS hold only query points / 3D tracks /
visibilities; the imagery must be computed locally from the ADT scenes
(Aria VRS recordings) because the dataset license forbids redistribution.
This module reimplements that computation (reference:
tapnet/tapvid3d/annotation_generation/adt_utils.py:44-188 and
generate_adt.py:63-98): per 300-frame chunk, undistort the fisheye RGB
stream to a 512x512 linear pinhole camera (f=280, c=256), rotate upright,
JPEG-encode, verify against the released per-frame means, and join with the
downloaded annotation npz.

`projectaria_tools` (the Aria toolkit) is required only for reading VRS
sequences; everything downstream of raw frames is pure numpy/PIL and
injectable for testing (`process_sequence(..., reader=...)`).
"""

from __future__ import annotations

import collections
import glob
import io
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Fixed generation hyperparameters (reference adt_utils.py:38-41).
N_FRAMES = 300
HEIGHT = 512
WIDTH = 512
FOCAL_LENGTH = 280
RGB_STREAM_ID = "214-1"


def adt_v2_sequence_name(v1_name: str) -> str:
  """Maps a TAPVid-3D (ADT v1) sequence name to its ADT v2 directory name.

  The reference vendors this as a 215-entry literal dict
  (annotation_generation/adt_v1v2_mappings.py). The mapping is exactly a
  machine-id suffix per release family — verified exhaustively against all
  215 reference entries (zero mismatches).
  """
  if v1_name.startswith("Apartment_release_multiskeleton_party_"):
    return v1_name + "_71292"
  if v1_name.startswith("Lite_release_recognition_"):
    return v1_name + "_61283"
  return v1_name + "_M1292"


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
  """JPEG-encodes an HxWx3 uint8 frame (the reference uses
  tf.io.encode_jpeg, default quality 95)."""
  from PIL import Image

  buf = io.BytesIO()
  Image.fromarray(image).save(buf, format="JPEG", quality=quality)
  return buf.getvalue()


def rotate_upright(image: np.ndarray) -> np.ndarray:
  """90-degree clockwise rotation (PIL rotate(-90) on the square Aria
  frame, reference adt_utils.py:165)."""
  return np.ascontiguousarray(np.rot90(image, k=-1))


def assemble_example(
    rgb_frames: Sequence[np.ndarray],
    annotation: Dict[str, np.ndarray],
    verify_means: bool = True,
) -> Dict[str, object]:
  """Joins computed imagery with a downloaded annotation npz's fields.

  Frames must already be upright (post `rotate_upright`). When the
  annotation carries `video_means` (released files do), the per-frame RGB
  means are checked against it — this is the integrity handshake proving
  the locally-read ADT scene is the one the tracks were generated from
  (reference adt_utils.py:176-178).
  """
  if verify_means and "video_means" in annotation:
    means = np.stack([f.mean(axis=(0, 1)) for f in rgb_frames])
    expected = np.asarray(annotation["video_means"])
    if means.shape != expected.shape or not np.allclose(
        means, expected, atol=1e-3
    ):
      raise ValueError(
          "Frame means do not match the released video_means — wrong ADT "
          f"scene or chunk? got {means.shape}, expected {expected.shape}"
      )
  return {
      "images_jpeg_bytes": [encode_jpeg(f) for f in rgb_frames],
      "queries_xyt": annotation["queries_xyt"],
      "tracks_XYZ": annotation["tracks_XYZ"],
      "visibility": annotation["visibility"],
      "fx_fy_cx_cy": np.array(
          [FOCAL_LENGTH, FOCAL_LENGTH, WIDTH / 2, HEIGHT / 2]
      ),
  }


class AriaSequenceReader:
  """Reads undistorted RGB frames from one ADT scene via projectaria_tools.

  Wraps the Aria data-provider plumbing (reference adt_utils.py:48-144):
  annotated capture timestamps of the RGB stream, and per-timestamp frames
  reprojected from the Aria fisheye onto the fixed 512x512 linear camera.
  """

  def __init__(self, sequence_path: str):
    try:
      from projectaria_tools.core import calibration
      from projectaria_tools.core.stream_id import StreamId
      from projectaria_tools.projects import adt as aria_adt
    except ImportError as e:
      raise ImportError(
          "projectaria_tools is required to read ADT scenes "
          "(pip install projectaria-tools); the downloaded annotation npz "
          "files alone do not contain imagery."
      ) from e
    self._calibration = calibration
    paths = aria_adt.AriaDigitalTwinDataPathsProvider(
        sequence_path
    ).get_datapaths_by_device_num(0, False)
    self._provider = aria_adt.AriaDigitalTwinDataProvider(paths)
    self._stream = StreamId(RGB_STREAM_ID)
    ts = np.array(
        self._provider.get_aria_device_capture_timestamps_ns(self._stream)
    )
    ts = ts[ts > self._provider.get_start_time_ns()]
    self.timestamps_ns = ts[ts < self._provider.get_end_time_ns()]

    raw = self._provider.raw_data_provider_ptr()
    sensor_name = raw.get_label_from_stream_id(self._stream)
    self._src_calib = raw.get_device_calibration().get_camera_calib(
        sensor_name
    )
    identity = calibration.get_linear_camera_calibration(
        1, 1, 1
    ).get_transform_device_camera()
    self._dst_calib = calibration.CameraCalibration(
        "camera-rgb",
        calibration.CameraModelType.LINEAR,
        np.array([FOCAL_LENGTH, FOCAL_LENGTH, WIDTH / 2, HEIGHT / 2]),
        identity,
        WIDTH,
        HEIGHT,
        None,
        np.pi,
        "LinearCameraCalibration",
    )

  def read_chunk(
      self, chunk_timestamps_ns: Iterable[int]
  ) -> List[np.ndarray]:
    """Undistorted RGB frames at the given timestamps (invalid skipped)."""
    frames = []
    for ts in chunk_timestamps_ns:
      with_dt = self._provider.get_aria_image_by_timestamp_ns(
          ts, self._stream
      )
      if not with_dt.is_valid():
        continue
      image = with_dt.data().to_numpy_array()
      frames.append(
          self._calibration.distort_by_calibration(
              image, self._dst_calib, self._src_calib
          )
      )
    return frames


def process_sequence(
    adt_base_path: str,
    input_npz_dir: str,
    output_npz_dir: str,
    seq_name: str,
    chunks: Sequence[int],
    reader: Optional[object] = None,
) -> List[str]:
  """Computes the full npz for each chunk of one ADT sequence.

  `reader` defaults to an `AriaSequenceReader` over the v2 scene directory;
  tests inject a fake with the same `timestamps_ns` / `read_chunk` surface.
  """
  if reader is None:
    reader = AriaSequenceReader(
        os.path.join(adt_base_path, adt_v2_sequence_name(seq_name))
    )
  os.makedirs(output_npz_dir, exist_ok=True)
  written = []
  for chunk_idx in chunks:
    ts = reader.timestamps_ns[
        chunk_idx * N_FRAMES : (chunk_idx + 1) * N_FRAMES
    ]
    frames = [rotate_upright(f) for f in reader.read_chunk(ts)]
    name = f"{seq_name}_{chunk_idx}.npz"
    with np.load(
        os.path.join(input_npz_dir, name), allow_pickle=True
    ) as z:
      annotation = {k: z[k] for k in z.files}
    example = assemble_example(frames, annotation)
    out_path = os.path.join(output_npz_dir, name)
    np.savez(out_path, **example)
    written.append(out_path)
  return written


def pending_chunks_by_sequence(
    input_npz_dir: str, output_npz_dir: str
) -> Dict[str, List[int]]:
  """Groups not-yet-generated `{seq}_{chunk}.npz` files by sequence
  (reference generate_adt.py:68-88)."""
  done = {
      os.path.basename(p)
      for p in glob.glob(os.path.join(output_npz_dir, "*.npz"))
  }
  pending = collections.defaultdict(list)
  for path in sorted(glob.glob(os.path.join(input_npz_dir, "*.npz"))):
    base = os.path.basename(path)
    if base in done:
      continue
    stem_parts = base[: -len(".npz")].split("_")
    pending["_".join(stem_parts[:-1])].append(int(stem_parts[-1]))
  return dict(pending)


def generate_adt(
    adt_base_path: str,
    input_npz_dir: str,
    output_npz_dir: str,
    verbose: bool = True,
) -> List[str]:
  """Generates every pending ADT example npz (annotations must already be
  downloaded into `input_npz_dir`; see generation.download_annotations)."""
  written = []
  pending = pending_chunks_by_sequence(input_npz_dir, output_npz_dir)
  for i, (seq, chunks) in enumerate(pending.items()):
    if verbose:
      print(f"[{i + 1}/{len(pending)}] {seq}: chunks {sorted(chunks)}")
    written.extend(
        process_sequence(
            adt_base_path, input_npz_dir, output_npz_dir, seq, chunks
        )
    )
  return written
