"""Atomic numpy checkpointing of the training state (port of
tapnet_tpu/training/checkpointing.py).

One pickled .npy dict of numpy arrays and Python scalars, written to a tmp
file and renamed into place with `os.replace`, so a crash never leaves a
half-written checkpoint. The trainer stores its parameters and optimizer
moments as Flax-layout trees (`checkpoints.convert.state_dict_to_tapnext`),
so the JAX package reads the parameters as they are.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch


def _to_host(value):
  if isinstance(value, Mapping):
    return {k: _to_host(v) for k, v in value.items()}
  if isinstance(value, torch.Tensor):
    return value.detach().cpu().numpy()
  return value


def save_checkpoint(path: str, state: Mapping[str, Any]) -> None:
  """Atomically writes a nested dict of arrays and scalars to `path`."""
  host_state = _to_host(state)
  tmp = path + "_tmp"
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(tmp, "wb") as f:
    np.save(f, host_state, allow_pickle=True)
  os.replace(tmp, path)


def restore_checkpoint(path: str) -> Optional[Mapping[str, Any]]:
  """Loads a checkpoint dict written by `save_checkpoint`, or None if there
  is none. Unpickles: load only checkpoints this program wrote."""
  if not os.path.exists(path):
    return None
  with open(path, "rb") as f:
    return np.load(f, allow_pickle=True).item()
