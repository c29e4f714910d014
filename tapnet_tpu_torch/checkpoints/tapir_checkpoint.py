"""Load TAPIR checkpoints into a Flax-layout numpy tree (port's own copy of
tapnet_tpu/checkpoints/tapir_checkpoint.py; pure numpy).

Two checkpoint families load here:
  * released reference checkpoints: Haiku .npy pickles whose params map
    module paths like ``tapir/~/pips_mlp_mixer/block_3/mlp1_up`` to {w, b}
    arrays, renamed by `convert_haiku_tapir_params` (layouts are identical,
    so conversion is pure renaming);
  * this framework's own checkpoints, whose params are already a nested
    Flax tree (float16 compact exports are upcast to float32).

`checkpoints.convert` then turns the tree into the port's `state_dict`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np


def _set(tree: Dict[str, Any], path, value):
  node = tree
  for k in path[:-1]:
    node = node.setdefault(k, {})
  node[path[-1]] = value


_LEAF_MAP = {"w": "kernel", "b": "bias", "scale": "scale", "offset": "offset"}
_LN_LEAF_MAP = {"scale": "scale", "offset": "bias"}

_COST_VOLUME_MODS = {
    "cost_volume_regression_1": "pos_conv",
    "cost_volume_regression_2": "pos_out",
    "cost_volume_occlusion_1": "occ_conv",
    "cost_volume_occlusion_2": "occ_dense",
    "occlusion_out": "occ_out",
}


def _block_index(suffix: str) -> int:
  """Haiku auto-names repeated modules '', '_1', '_2', ..."""
  return 0 if not suffix else int(suffix[1:])


def convert_haiku_tapir_params(
    hk_params: Mapping[str, Mapping[str, np.ndarray]],
) -> Dict[str, Any]:
  """Converts a reference Haiku TAPIR param dict to tapnet_tpu Flax params."""
  out: Dict[str, Any] = {}
  for mod, leaves in hk_params.items():
    mod = mod.replace("/~/", "/")
    parts = mod.split("/")
    if parts[0] != "tapir":
      raise ValueError(f"Unexpected root module: {mod}")
    parts = parts[1:]

    for leaf_name, value in leaves.items():
      value = np.asarray(value)
      path = None

      if parts[0] == "resnet":
        sub = parts[1:]
        if sub[0] == "initial_conv":
          path = ("backbone", "stem_conv", _LEAF_MAP[leaf_name])
        else:
          g = int(re.fullmatch(r"block_group_(\d+)", sub[0]).group(1))
          b = int(re.fullmatch(r"block_(\d+)", sub[1]).group(1))
          layer = sub[2]
          block = f"group_{g}_block_{b}"
          if layer == "shortcut_conv":
            path = ("backbone", block, "proj_conv", _LEAF_MAP[leaf_name])
          elif m := re.fullmatch(r"conv_(\d+)", layer):
            path = (
                "backbone", block, f"conv_{m.group(1)}", _LEAF_MAP[leaf_name]
            )
          elif m := re.fullmatch(r"(?:instancenorm|layernorm|batchnorm)_(\d+)", layer):
            path = (
                "backbone", block, f"norm_{m.group(1)}", _LEAF_MAP[leaf_name]
            )
          elif layer in ("shortcut_instancenorm", "shortcut_layernorm",
                         "shortcut_batchnorm"):
            path = ("backbone", block, "proj_norm", _LEAF_MAP[leaf_name])

      elif parts[0] in _COST_VOLUME_MODS:
        path = (
            "cost_volume_head",
            _COST_VOLUME_MODS[parts[0]],
            _LEAF_MAP[leaf_name],
        )

      elif parts[0] == "pips_mlp_mixer":
        sub = parts[1]
        if sub == "linear":
          path = ("mixer", "in_proj", _LEAF_MAP[leaf_name])
        elif sub == "linear_1":
          path = ("mixer", "out_proj", _LEAF_MAP[leaf_name])
        elif sub == "layer_norm":
          path = ("mixer", "ln_out", _LN_LEAF_MAP[leaf_name])
        elif m := re.fullmatch(r"block(_\d+)?", sub):
          i = _block_index(m.group(1) or "")
          block = f"block_{i}"
          layer = parts[2]
          if layer == "layer_norm":
            path = ("mixer", block, "ln_temporal", _LN_LEAF_MAP[leaf_name])
          elif layer == "layer_norm_1":
            path = ("mixer", block, "ln_channel", _LN_LEAF_MAP[leaf_name])
          elif layer == "mlp1_up":
            path = ("mixer", block, "temporal", "dw_up", _LEAF_MAP[leaf_name])
          elif layer == "mlp1_up_1":
            path = ("mixer", block, "temporal", "dw_mix", _LEAF_MAP[leaf_name])
          elif layer == "mlp2_up":
            path = ("mixer", block, "fc_up", _LEAF_MAP[leaf_name])
          elif layer == "mlp2_down":
            path = ("mixer", block, "fc_down", _LEAF_MAP[leaf_name])

      elif parts[0] == "extra_convs":
        sub = parts[1]
        if m := re.fullmatch(r"layer_norm(_\d+)?", sub):
          i = _block_index(m.group(1) or "")
          path = ("extra", f"ln_{i}", _LN_LEAF_MAP[leaf_name])
        elif m := re.fullmatch(r"conv2_d(_\d+)?", sub):
          j = _block_index(m.group(1) or "")
          kind = "conv_up" if j % 2 == 0 else "conv_out"
          path = ("extra", f"{kind}_{j // 2}", _LEAF_MAP[leaf_name])

      if path is None:
        raise ValueError(f"Unmapped checkpoint entry: {mod}/{leaf_name}")
      _set(out, path, value)

  return out


def load_tapir_checkpoint(path: str) -> Dict[str, Any]:
  """Loads TAPIR params from either checkpoint family:

  * released reference checkpoints: Haiku .npy pickles whose params map
    module-path strings like ``tapir/~/pips_mlp_mixer/...`` (converted by
    renaming), or
  * this framework's own training checkpoints
    (training/checkpointing.py: {params, opt_state, step, ...} with the
    params already a nested Flax tree) — returned as-is, so
    `tapvid.evaluate --checkpoint runs/.../checkpoint.npy` works on a
    checkpoint trained here.
  """
  ckpt = np.load(path, allow_pickle=True).item()
  params = ckpt.get("params", ckpt)
  if any("/" in str(k) for k in params):
    return convert_haiku_tapir_params(params)

  def upcast(v):
    # Compact artifacts (tools/export_trained_params.py) store float16;
    # restore fp32 so compute-dtype handling stays uniform downstream.
    if isinstance(v, dict):
      return {k: upcast(x) for k, x in v.items()}
    arr = np.asarray(v)
    return arr.astype(np.float32) if arr.dtype == np.float16 else arr

  return upcast(params)
