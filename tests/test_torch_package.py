"""PyTorch port, package boundary: it imports no JAX, Flax or tapnet_tpu
module, directly or indirectly; its entry points refuse to fall back to the
CPU; its kernels build only from its own sources, at first CUDA use.
"""

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import tapnet_tpu_torch
from tapnet_tpu_torch.inference import TapirPredictor, resolve_device
from tapnet_tpu_torch.models.tapir import bootstapir_config
from tapnet_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(tapnet_tpu_torch.__file__)


def _package_modules():
  mods = []
  for root, dirs, files in os.walk(PKG):
    dirs[:] = [d for d in dirs if not d.startswith(("_build", "__pycache__"))]
    for f in files:
      if f.endswith(".py"):
        rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
        mod = rel.replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith("__init__") else mod)
  return sorted(mods)


def test_import_pulls_in_no_jax():
  code = (
      "import importlib, sys\n"
      f"for m in {_package_modules()!r}:\n"
      "  importlib.import_module(m)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=120,
  )
  assert res.returncode == 0, res.stderr


def test_sources_name_no_jax():
  pattern = re.compile(r"\bjax\b|\bflax\b|\btapnet_tpu\.")
  offenders = []
  for root, dirs, files in os.walk(PKG):
    dirs[:] = [d for d in dirs if not d.startswith(("_build", "__pycache__"))]
    for f in files:
      if f.endswith((".py", ".cu", ".cuh")):
        path = os.path.join(root, f)
        with open(path) as fh:
          for i, line in enumerate(fh, 1):
            if pattern.search(line):
              offenders.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
  assert not offenders, "\n".join(offenders)


def test_predictor_refuses_cpu_fallback():
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is usable")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    TapirPredictor({}, bootstapir_config())
  with pytest.raises(RuntimeError):
    resolve_device("cuda")
  assert resolve_device("cpu").type == "cpu"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
  """A build that cannot run raises; nothing falls back to the plain
  versions. Imports needed no toolchain."""
  monkeypatch.setenv("PATH", str(tmp_path))
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
  with pytest.raises(RuntimeError, match="nvcc"):
    _build.build_all(["corr_tents"])


def test_build_key_follows_sources():
  names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
  assert names == ["corr_tents", "fused_mixer_block"]
  paths = {_build._library_path(n) for n in names}  # pylint: disable=protected-access
  assert len(paths) == 2
  assert all(p.parent == _build.BUILD_DIR for p in paths)
