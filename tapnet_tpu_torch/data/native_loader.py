"""ctypes binding for the native C++ video ingest pipeline (port of
tapnet_tpu/data/native_loader.py).

`NativeVideoLoader` streams batches of resized+normalized video from .npy
files (uint8 [T, H, W, 3]) using the threaded C++ prefetcher in
`data/native/loader.cc` (the port's own copy): decode, resize and
normalize run in native worker threads without the GIL, so the host keeps
the card fed while Python runs the train loop. `num_threads=0` asks for the
pure-numpy implementation of the same semantics.

The library is built with g++ at its first use into tapnet_tpu_torch/_build/
(keyed by a hash of the source); a build that fails raises, and nothing
falls back to the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "loader.cc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _library_path() -> pathlib.Path:
  with open(_SRC, "rb") as f:
    tag = hashlib.sha256(f.read()).hexdigest()[:16]
  return BUILD_DIR / f"libtnl_{tag}.so"


def load_library() -> ctypes.CDLL:
  """Compiles (once, content-hashed) and loads the native library; raises
  RuntimeError if it cannot be built."""
  global _LIB
  with _LIB_LOCK:
    if _LIB is not None:
      return _LIB
    so_path = _library_path()
    if not so_path.exists():
      so_path.parent.mkdir(parents=True, exist_ok=True)
      tmp = f"{so_path}.{os.getpid()}.tmp"
      cmd = [
          "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
          _SRC, "-o", tmp,
      ]
      try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
      except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise RuntimeError(
            f"native loader build failed: {e} "
            f"{detail.decode(errors='replace')}") from e
      os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.tnl_create.restype = ctypes.c_void_p
    lib.tnl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.tnl_next.restype = ctypes.c_int
    lib.tnl_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    ]
    lib.tnl_batch_floats.restype = ctypes.c_int64
    lib.tnl_batch_floats.argtypes = [ctypes.c_void_p]
    lib.tnl_destroy.argtypes = [ctypes.c_void_p]
    lib.tnl_last_error.restype = ctypes.c_char_p
    _LIB = lib
    return _LIB


def resize_normalize_reference(
    video_u8: np.ndarray, out_h: int, out_w: int
) -> np.ndarray:
  """Pure-numpy oracle for the native kernel: bilinear (half-pixel centers,
  edge clamp) resize of uint8 [T, H, W, 3] to float32 [-1, 1]."""
  t, h, w, _ = video_u8.shape
  sy, sx = h / out_h, w / out_w
  fy = np.clip((np.arange(out_h) + 0.5) * sy - 0.5, 0, h - 1)
  fx = np.clip((np.arange(out_w) + 0.5) * sx - 0.5, 0, w - 1)
  y0 = fy.astype(np.int64)
  x0 = fx.astype(np.int64)
  y1 = np.minimum(y0 + 1, h - 1)
  x1 = np.minimum(x0 + 1, w - 1)
  wy = (fy - y0).astype(np.float32)[None, :, None, None]
  wx = (fx - x0).astype(np.float32)[None, None, :, None]
  v = video_u8.astype(np.float32)
  top = v[:, y0][:, :, x0] * (1 - wx) + v[:, y0][:, :, x1] * wx
  bot = v[:, y1][:, :, x0] * (1 - wx) + v[:, y1][:, :, x1] * wx
  out = top * (1 - wy) + bot * wy
  return out / 127.5 - 1.0


class NativeVideoLoader:
  """Iterator of [B, T, H, W, 3] float32 batches in [-1, 1].

  Args:
    files: .npy paths, each uint8 [T, H, W, 3].
    batch_size / num_frames / height / width: output batch geometry (short
      clips repeat their last frame).
    num_threads: native worker threads (0: the pure-numpy path).
    prefetch: bounded queue depth of prepared batches.
    shuffle: reshuffle the file order each epoch.
  """

  def __init__(
      self,
      files: Sequence[str],
      batch_size: int = 8,
      num_frames: int = 24,
      height: int = 256,
      width: int = 256,
      num_threads: int = 4,
      prefetch: int = 2,
      seed: int = 0,
      shuffle: bool = True,
  ):
    if not files:
      raise ValueError("empty file list")
    self.files = list(files)
    self.batch_size = batch_size
    self.num_frames = num_frames
    self.height = height
    self.width = width
    self._shape = (batch_size, num_frames, height, width, 3)
    self._handle = None
    self._lib = load_library() if num_threads > 0 else None
    if self._lib is not None:
      arr = (ctypes.c_char_p * len(self.files))(
          *[f.encode() for f in self.files]
      )
      self._handle = self._lib.tnl_create(
          arr, len(self.files), batch_size, num_frames, height, width,
          num_threads, prefetch, seed, int(shuffle),
      )
      if not self._handle:
        raise RuntimeError(
            self._lib.tnl_last_error().decode(errors="replace")
        )
    else:
      self._rng = np.random.RandomState(seed)
      self._order: list = []
      self._shuffle = shuffle

  @property
  def is_native(self) -> bool:
    return self._handle is not None

  def __iter__(self):
    return self

  def __next__(self) -> np.ndarray:
    if self._handle is not None:
      out = np.empty(self._shape, np.float32)
      rc = self._lib.tnl_next(
          self._handle,
          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      )
      if rc != 0:
        raise RuntimeError(
            self._lib.tnl_last_error().decode(errors="replace")
        )
      return out
    return self._python_next()

  def _python_next(self) -> np.ndarray:
    out = np.empty(self._shape, np.float32)
    for e in range(self.batch_size):
      if not self._order:
        self._order = list(range(len(self.files)))
        if self._shuffle:
          self._rng.shuffle(self._order)
      video = np.load(self.files[self._order.pop(0)])
      t = video.shape[0]
      idx = np.minimum(np.arange(self.num_frames), t - 1)
      out[e] = resize_normalize_reference(
          video[idx], self.height, self.width
      )
    return out

  def close(self) -> None:
    if self._handle is not None:
      self._lib.tnl_destroy(self._handle)
      self._handle = None

  def __del__(self):
    try:
      self.close()
    except Exception:
      pass
