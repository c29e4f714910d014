"""TAPNext checkpoint IO: released flat .npz <-> a Flax-layout numpy tree
(port's own copy of tapnet_tpu/checkpoints/tapnext_checkpoint.py; pure
numpy).

Released TAPNext checkpoints are flat npz files keyed by Flax paths like
``backbone/Transformer/encoderblock_3/ssm_block/recurrent_block/rg_lru/a_param``.
`checkpoints.convert.load_tapnext_params` then turns the tree into the
port's `state_dict`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
  """{'a/b/c': x} -> {'a': {'b': {'c': x}}}"""
  tree: Dict[str, Any] = {}
  for key, value in flat.items():
    parts = key.split("/")
    node = tree
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)
  return tree


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
  out: Dict[str, np.ndarray] = {}
  for k, v in tree.items():
    key = f"{prefix}/{k}" if prefix else k
    if isinstance(v, Mapping):
      out.update(flatten(v, key))
    else:
      out[key] = np.asarray(v)
  return out


def load_tapnext_checkpoint(path: str) -> Dict[str, Any]:
  """Loads a released flat .npz TAPNext checkpoint into Flax params."""
  with np.load(path) as ckpt:
    return unflatten({k: ckpt[k] for k in ckpt.files})


def save_tapnext_checkpoint(path: str, params: Mapping[str, Any]) -> None:
  """Saves Flax params as a released-format flat .npz."""
  np.savez(path, **flatten(params))


def _cubic_weights(out_size: int, in_size: int):
  """Per-output-row 4-tap cubic-convolution weights and (clamped) source
  indices, matching torch F.interpolate(mode="bicubic",
  align_corners=False): half-pixel centers and the Keys kernel with
  a = -0.75 (a Keys kernel with a = -0.5 diverges from the reference torch
  oracle by up to ~10% on random grids)."""
  a = -0.75
  x = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size)
  x = x - 0.5
  i0 = np.floor(x).astype(np.int64)
  taps = i0[:, None] + np.arange(-1, 3)[None, :]  # [out, 4]
  t = np.abs(x[:, None] - taps)
  w = np.where(
      t <= 1.0,
      ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
      np.where(t < 2.0, a * (((t - 5.0) * t + 8.0) * t - 4.0), 0.0),
  )
  return w, np.clip(taps, 0, in_size - 1)


def _resize_posemb(pe: np.ndarray, new_hw, name: str) -> np.ndarray:
  """Bicubically resizes a [1, h*w, c] learned posemb to a new square-ish
  grid, bit-matching the torch oracle's
  F.interpolate(mode="bicubic", align_corners=False)
  (reference: tapnext_torch.py:248-284)."""
  tokens, c = pe.shape[1], pe.shape[2]
  native = int(round(np.sqrt(tokens)))
  if native * native != tokens:
    raise ValueError(
        f"{name} has {tokens} tokens (not a perfect square); cannot"
        " interpolate."
    )
  nh, nw = new_hw
  if (nh, nw) == (native, native):
    return pe
  grid = pe.reshape(native, native, c).astype(np.float64)
  wh, ih = _cubic_weights(nh, native)
  ww, iw = _cubic_weights(nw, native)
  # Rows: [nh, 4] weights over clamped source rows -> [nh, native, c].
  rows = np.einsum("ok,okwc->owc", wh, grid[ih])
  # Cols: [nw, 4] weights over clamped source cols -> [nh, nw, c].
  out = np.einsum("ok,hokc->hoc", ww, rows[:, iw])
  return out.reshape(1, nh * nw, c).astype(pe.dtype)


def adapt_posembs(
    params: Mapping[str, Any],
    old_config,
    new_config,
) -> Dict[str, Any]:
  """Adapts learned positional embeddings to a new input resolution.

  Mirrors the reference's resolution adaptation for TAPNext++ at 512 input
  (tapnext_torch.py:248-284, `_video_pos_emb` bicubic interpolation): the
  per-patch image posemb is interpolated onto the denser patch grid, and
  the full-resolution query posemb onto the new pixel grid. Done once at
  checkpoint-load time (the interpolation is input-independent), keeping
  the model forward static-shaped.

  Args:
    params: Flax params from `load_tapnext_checkpoint`.
    old_config: SsmVitConfig the checkpoint was trained with.
    new_config: SsmVitConfig to run with (e.g. image_size=(512, 512)).

  Returns:
    New params pytree with resized `pos_embedding` / `pos_embedding_full`.
  """
  patch_hw = (
      new_config.image_size[0] // new_config.patch_size[1],
      new_config.image_size[1] // new_config.patch_size[2],
  )
  full_hw = (
      new_config.image_size[0] * new_config.query_scale,
      new_config.image_size[1] * new_config.query_scale,
  )

  def walk(node):
    out = {}
    for k, v in node.items():
      if isinstance(v, Mapping):
        out[k] = walk(v)
      elif k == "pos_embedding":
        out[k] = _resize_posemb(np.asarray(v), patch_hw, k)
      elif k == "pos_embedding_full":
        out[k] = _resize_posemb(np.asarray(v), full_hw, k)
      else:
        out[k] = v
    return out

  del old_config  # shapes are recovered from the params themselves
  return walk(params)
