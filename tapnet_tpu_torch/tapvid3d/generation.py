"""TAPVid-3D annotation download / assembly utilities (the port's own copy
of tapnet_tpu/tapvid3d/generation.py; numpy, cv2 imported lazily).

Capability parity: tapnet/tapvid3d/annotation_generation/ (gcs_utils +
generate_{adt,pstudio,drivetrack}). The official annotations are
distributed as npz files on GCS; DriveTrack ships complete npz files
(generation = bulk download of a split), PStudio ships annotations that are
joined with user-downloaded frames here, and ADT ships query points whose
imagery is computed locally from the Aria scenes (tapvid3d/adt.py).

All downloads use plain HTTPS (no gcloud dependency). CLI:
  python -m tapnet_tpu_torch.tapvid3d.generation --source drivetrack \
      --split minival --output_dir tapvid3d_dataset/drivetrack
"""

from __future__ import annotations

import io
import os
import urllib.request
from typing import Iterable, List, Optional, Sequence

import numpy as np

from tapnet_tpu_torch.tapvid3d import splits as splits_lib

# Reference gcs_utils.py:30-32 (release_files/v1.0 is the benchmark pin).
GCS_BASE_URL = (
    "https://storage.googleapis.com/dm-tapnet/tapvid3d/release_files/v1.0"
)
SOURCES = ("adt", "pstudio", "drivetrack")


def download_file(url: str, dest: str, overwrite: bool = False) -> str:
  """HTTPS download with a temp-file + rename (idempotent)."""
  if os.path.exists(dest) and not overwrite:
    return dest
  os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
  tmp = dest + ".tmp"
  urllib.request.urlretrieve(url, tmp)
  os.replace(tmp, dest)
  return dest


def download_annotations(
    source: str,
    npz_filenames: Sequence[str],
    output_dir: str,
    base_url: str = GCS_BASE_URL,
    verbose: bool = True,
) -> List[str]:
  """Fetches the listed annotation npz files for one data source."""
  if source not in SOURCES:
    raise ValueError(f"Unknown source {source!r}; expected one of {SOURCES}")
  paths = []
  for i, name in enumerate(npz_filenames):
    url = f"{base_url}/{source}/{name}"
    dest = os.path.join(output_dir, source, name)
    paths.append(download_file(url, dest))
    if verbose:
      print(f"[{i + 1}/{len(npz_filenames)}] {name}")
  return paths


def download_split(
    source: str,
    split: str,
    output_dir: str,
    base_url: str = GCS_BASE_URL,
    debug: bool = False,
    verbose: bool = True,
) -> List[str]:
  """Downloads one benchmark split ("minival" / "full_eval" / "all") of a
  source's npz files (reference gcs_utils.download_tapvid3d_files)."""
  if split == "all":
    names = splits_lib.get_all_files(source)
  else:
    names = splits_lib.get_split_files(source, split)
  if debug:
    names = names[:1]
  return download_annotations(
      source, names, output_dir, base_url=base_url, verbose=verbose
  )


def generate_drivetrack(
    output_dir: str, split: str = "all", debug: bool = False
) -> List[str]:
  """DriveTrack generation: the released npz files are complete (imagery
  included), so this is a bulk split download
  (reference generate_drivetrack.py)."""
  return download_split("drivetrack", split, output_dir, debug=debug)


def join_pstudio_frames(
    annotation_npz: str,
    frames_dir: str,
    output_npz: str,
    jpeg_quality: int = 95,
) -> str:
  """Joins a PStudio annotation npz (tracks/visibility/intrinsics + frame
  names) with user-downloaded frames into a complete example npz."""
  import cv2

  with np.load(annotation_npz, allow_pickle=True) as z:
    data = {k: z[k] for k in z.files}

  frame_names = data.pop("images_jpeg_names", None)
  if frame_names is None:
    if "images_jpeg_bytes" in data:
      # Annotation already contains imagery.
      np.savez(output_npz, **data)
      return output_npz
    # The released PStudio annotations carry no frame list: the frames are
    # the sorted jpgs of the sequence/camera directory (reference
    # generate_pstudio.py:93-96).
    import glob

    frame_names = [
        os.path.basename(p)
        for p in sorted(glob.glob(os.path.join(frames_dir, "*.jpg")))
    ]
    if not frame_names:
      raise FileNotFoundError(f"no frames in {frames_dir}")

  jpegs = []
  for name in frame_names:
    path = os.path.join(frames_dir, str(name))
    img = cv2.imread(path)
    if img is None:
      raise FileNotFoundError(path)
    ok, buf = cv2.imencode(
        ".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), jpeg_quality]
    )
    if not ok:
      raise ValueError(f"JPEG encode failed for {path}")
    jpegs.append(buf.tobytes())

  data["images_jpeg_bytes"] = np.array(jpegs, object)
  np.savez(output_npz, **data)
  return output_npz


def verify_example(npz_path: str) -> dict:
  """Sanity-checks a TAPVid-3D example npz; returns its shape summary."""
  with np.load(npz_path, allow_pickle=True) as z:
    required = (
        "images_jpeg_bytes",
        "queries_xyt",
        "tracks_XYZ",
        "visibility",
        "fx_fy_cx_cy",
    )
    missing = [k for k in required if k not in z.files]
    if missing:
      raise ValueError(f"{npz_path}: missing keys {missing}")
    t, n = z["tracks_XYZ"].shape[:2]
    if z["visibility"].shape != (t, n):
      raise ValueError(
          f"{npz_path}: visibility {z['visibility'].shape} != {(t, n)}"
      )
    if z["queries_xyt"].shape != (n, 3):
      raise ValueError(
          f"{npz_path}: queries {z['queries_xyt'].shape} != {(n, 3)}"
      )
    if len(z["images_jpeg_bytes"]) != t:
      raise ValueError(f"{npz_path}: frame count != track length")
    return {
        "num_frames": int(t),
        "num_tracks": int(n),
        "intrinsics": z["fx_fy_cx_cy"].tolist(),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
  """Dataset generation entry point for all three sources (reference
  generate_{adt,pstudio,drivetrack}.py CLIs, merged)."""
  import argparse

  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--source", required=True, choices=SOURCES)
  parser.add_argument(
      "--split", default="all", choices=["minival", "full_eval", "all"]
  )
  parser.add_argument("--output_dir", required=True)
  parser.add_argument(
      "--adt_base_path", default="",
      help="Directory containing the ADT scenes (source=adt only).",
  )
  parser.add_argument(
      "--pstudio_frames_dir", default="",
      help="Extracted PStudio data root (source=pstudio only).",
  )
  parser.add_argument("--debug", action="store_true",
                      help="Process only one video.")
  parser.add_argument("--base_url", default=GCS_BASE_URL,
                      help="Annotation bucket (file:// works for mirrors).")
  args = parser.parse_args(argv)

  if args.source == "drivetrack":
    download_split(
        "drivetrack", args.split, args.output_dir,
        base_url=args.base_url, debug=args.debug,
    )
    return

  tmp_dir = os.path.join(args.output_dir, "tmp")
  download_split(
      args.source, args.split, tmp_dir,
      base_url=args.base_url, debug=args.debug,
  )
  annotation_dir = os.path.join(tmp_dir, args.source)

  if args.source == "adt":
    if not args.adt_base_path:
      parser.error("--adt_base_path is required for source=adt")
    from tapnet_tpu_torch.tapvid3d import adt

    adt.generate_adt(args.adt_base_path, annotation_dir, args.output_dir)
  else:  # pstudio
    if not args.pstudio_frames_dir:
      parser.error("--pstudio_frames_dir is required for source=pstudio")
    for name in sorted(os.listdir(annotation_dir)):
      if not name.endswith(".npz"):
        continue
      out = os.path.join(args.output_dir, name)
      if os.path.exists(out):
        continue
      seq, cam_id = name[: -len(".npz")].rsplit("_", 1)
      join_pstudio_frames(
          os.path.join(annotation_dir, name),
          os.path.join(args.pstudio_frames_dir, seq, "ims", cam_id),
          out,
      )
      print(name)


if __name__ == "__main__":
  main()
