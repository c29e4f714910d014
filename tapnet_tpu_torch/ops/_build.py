"""Builds and loads the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `_build/<name>-<hash>.so` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

keyed by a hash of the source, the shared headers `csrc/*.cuh` and the
flags, and is loaded with `ctypes`.
The build happens at the first CUDA launch of a kernel, never at import, so
the package imports on machines without a CUDA toolchain. `load` builds one
source; `build_all`, which `load` calls, starts one `nvcc` per source all
together, so a caller that needs every kernel waits for the slowest build
only. A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  candidate = Path(cuda_home) / "bin" / "nvcc"
  if candidate.exists():
    return str(candidate)
  raise RuntimeError(
      "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
      "kernels of tapnet_tpu_torch cannot be built."
  )


def _library_path(name: str) -> Path:
  src = SRC_DIR / f"{name}.cu"
  digest = hashlib.sha256(src.read_bytes())
  # The shared headers (csrc/*.cuh) too: a source may include any of them.
  for header in sorted(SRC_DIR.glob("*.cuh")):
    digest.update(header.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
  """Starts nvcc for one source; returns (process, tmp_path, final_path)."""
  out = _library_path(name)
  nvcc = _nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
  proc = subprocess.Popen(
      cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
  )
  return proc, tmp, out


def _finish_build(name: str, proc, tmp: str, out: Path) -> None:
  log, _ = proc.communicate()
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
  os.replace(tmp, out)


def build_all(names: Iterable[str] | None = None) -> List[str]:
  """Builds the given sources (default: every csrc/*.cu), one nvcc each,
  all started together. Returns the names that were compiled anew."""
  if names is None:
    names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
  with _LOCK:
    todo = [n for n in names if not _library_path(n).exists()]
    started = [(n, *_start_build(n)) for n in todo]
    errors = []
    for name, proc, tmp, out in started:
      try:
        _finish_build(name, proc, tmp, out)
      except RuntimeError as err:
        errors.append(str(err))
    if errors:
      raise RuntimeError("\n".join(errors))
  return todo


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
  """Loads (building first if needed) csrc/<name>.cu's library.

  `signatures` maps each C entry point to its ctypes argument types; every
  entry returns an int (the launch's cudaError_t). Each library also exports
  `tapnet_cuda_error_string`, which `check` uses.
  """
  with _LOCK:
    lib = _LIBS.get(name)
  if lib is not None:
    return lib
  build_all([name])
  lib = ctypes.CDLL(str(_library_path(name)))
  for fn_name, argtypes in signatures.items():
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
  lib.tapnet_cuda_error_string.argtypes = [ctypes.c_int]
  lib.tapnet_cuda_error_string.restype = ctypes.c_char_p
  with _LOCK:
    _LIBS[name] = lib
  return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
  """Raises if a C entry point reported a CUDA error."""
  if err != 0:
    msg = lib.tapnet_cuda_error_string(err).decode()
    raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
