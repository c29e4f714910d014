"""Import TAP-Net (Haiku, TSM-ResNet) checkpoints (port of
tapnet_tpu/checkpoints/tapnet_checkpoint.py, numpy only).

Returns the Flax-layout (params, batch_stats) trees, which
`checkpoints.convert.load_tapnet_params` loads into the port's TAPNet.

Reference checkpoint layout observed from haiku init of
tapnet/models/tapnet_model.py: params under `tap_net/~/tsm_resnet_video/...`
plus cost-volume heads, and BatchNorm EMA state under haiku state
(`.../batch_norm/~/mean_ema`). Flax wants batch stats in a separate
`batch_stats` collection with (C,)-shaped leaves (haiku stores (1,1,1,C)).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np

_LEAF_MAP = {"w": "kernel", "b": "bias", "scale": "scale", "offset": "bias"}

_HEAD_MODS = {
    "cost_volume_regression_1": "pos_conv",
    "cost_volume_regression_2": "pos_out",
    "cost_volume_occlusion_1": "occ_conv",
    "cost_volume_occlusion_2": "occ_dense",
    "occlusion_out": "occ_out",
}

# batch_norm call order inside a block -> our norm names.
_BN_ORDER_BASIC = {"batch_norm": "norm_pre", "batch_norm_1": "norm_1"}
_BN_ORDER_BOTTLENECK = {
    "batch_norm": "norm_pre",
    "batch_norm_1": "norm_0",
    "batch_norm_2": "norm_1",
}


def _set(tree: Dict[str, Any], path, value):
  node = tree
  for k in path[:-1]:
    node = node.setdefault(k, {})
  node[path[-1]] = value


def _backbone_path(parts, leaf_name, bottleneck):
  """Maps a tsm_resnet_video/... module path into our backbone tree."""
  sub = parts[0]
  if sub == "tsm_resnet_stem":
    return ("backbone", "stem_conv", _LEAF_MAP[leaf_name])
  if m := re.fullmatch(r"tsm_resnet_unit_(\d+)", sub):
    u = int(m.group(1))
    b = int(re.fullmatch(r"block_(\d+)", parts[1]).group(1))
    layer = parts[2]
    block = f"unit_{u}_block_{b}"
    bn_map = _BN_ORDER_BOTTLENECK if bottleneck else _BN_ORDER_BASIC
    if layer in bn_map:
      return ("backbone", block, bn_map[layer], _LEAF_MAP[leaf_name])
    if layer == "shortcut_conv":
      return ("backbone", block, "proj_conv", _LEAF_MAP[leaf_name])
    if re.fullmatch(r"conv_\d+", layer):
      return ("backbone", block, layer, _LEAF_MAP[leaf_name])
  if sub == "batch_norm":  # final norm before embeddings
    return ("backbone", "final_norm", _LEAF_MAP[leaf_name])
  return None


def convert_haiku_tapnet(
    hk_params: Mapping[str, Mapping[str, np.ndarray]],
    hk_state: Mapping[str, Mapping[str, np.ndarray]],
    bottleneck: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """Returns (params, batch_stats) Flax trees."""
  params: Dict[str, Any] = {}
  for mod, leaves in hk_params.items():
    parts = mod.replace("/~/", "/").split("/")
    if parts[0] != "tap_net":
      raise ValueError(f"Unexpected root: {mod}")
    parts = parts[1:]
    for leaf_name, value in leaves.items():
      value = np.asarray(value)
      if parts[0] == "tsm_resnet_video":
        path = _backbone_path(parts[1:], leaf_name, bottleneck)
        if path and "norm" in path[-2]:
          value = value.reshape(-1)  # (1,1,1,C) -> (C,)
      elif parts[0] in _HEAD_MODS:
        path = ("heads", _HEAD_MODS[parts[0]], _LEAF_MAP[leaf_name])
      else:
        path = None
      if path is None:
        raise ValueError(f"Unmapped param: {mod}/{leaf_name}")
      _set(params, path, value)

  batch_stats: Dict[str, Any] = {}
  for mod, leaves in hk_state.items():
    parts = mod.replace("/~/", "/").split("/")
    if parts[-1] not in ("mean_ema", "var_ema"):
      continue
    stat = "mean" if parts[-1] == "mean_ema" else "var"
    bn_parts = parts[1:-1]  # drop tap_net root and ema leaf
    if bn_parts[0] != "tsm_resnet_video":
      raise ValueError(f"Unexpected state module: {mod}")
    path = _backbone_path(bn_parts[1:], "scale", bottleneck)
    if path is None:
      raise ValueError(f"Unmapped state: {mod}")
    value = np.asarray(leaves["average"]).reshape(-1)
    _set(batch_stats, path[:-1] + (stat,), value)

  return params, batch_stats


def load_tapnet_checkpoint(path: str):
  """Loads a released .npy TAP-Net checkpoint into (params, batch_stats)."""
  ckpt = np.load(path, allow_pickle=True).item()
  return convert_haiku_tapnet(ckpt["params"], ckpt.get("state", {}))
