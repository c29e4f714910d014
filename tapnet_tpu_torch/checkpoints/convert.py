"""Weight bridge: Flax parameter tree (numpy leaves) -> the port's state_dict.

The port's modules carry the Flax module names as attribute names, so a Flax
path `backbone/group_0_block_0/conv_0/kernel` becomes the state_dict key
`backbone.group_0_block_0.conv_0.weight`. Leaf conversions:

  * `kernel` of rank 4 (HWIO conv) -> `weight` in OIHW;
  * `kernel` of rank 2 (Dense [in, out]) -> `weight` in Linear's [out, in];
  * `kernel` of rank 3 (depthwise temporal conv [k, 1, C*mult]) -> `weight`
    unchanged, keeping the c-major flat index c*mult + m that the mixer math
    and kernel read;
  * `bias`, `scale`, `offset` -> unchanged.

The int8 modes need no weights of their own: the int8 mixer weights and
their column scales are derived in the port from the converted float weights
(`models.layers.MixerBlock.quantized_weights`), as the JAX package derives
them from the same parameters.

TAPNext (`tapnext_to_state_dict`, `load_tapnext_params`) takes the released
flat-key tree (`checkpoints/tapnext_checkpoint.load_tapnext_checkpoint`):

  * Dense `kernel` [in, out] -> `weight` [out, in];
  * attention `query`/`key`/`value` kernels [D, heads, head_dim] -> `weight`
    [heads*head_dim, D] with biases [heads, head_dim] flattened, and the
    `out` kernel [heads, head_dim, D] -> `weight` [D, heads*head_dim];
  * the patch embedding's kernel [1, ph, pw, 3, D] -> `weight` [D, ph*pw*3]
    (the order of the port's patch reshape);
  * the block-diagonal gates (`w`, `b`), the temporal conv (`w` [k, C], `b`),
    the paired up-projection (`w` [2, d, D], `b` [2, 1, 1, D]), `a_param`,
    norms, tokens and position embeddings -> unchanged.

Any leaf the bridge does not know, any key the model does not have, any
parameter of the model left unfilled and any shape mismatch raises.

The generic ResNet (`load_resnet_params`) takes the JAX ResNet's trees:
its v1 `stem_norm` and `proj_norm`, LayerNorm's and BatchNorm's `scale` and
`bias`, InstanceNorm's `scale` and `offset` map by name, and BatchNorm's
`mean`/`var` come from `batch_stats`.

TAP-Net (`tapnet_to_state_dict`, `load_tapnet_params`) takes Flax's
(params, batch_stats) trees: the conv kernels as TAPIR's, the heads'
(1, 3, 3, C_in, C_out) kernels as 2D OIHW (they act on one frame at a
time), Dense kernels transposed, and BatchNorm's `scale`/`bias` parameters
and `mean`/`var` running statistics (the model's buffers) unchanged. A
backbone module the model does not build (a released checkpoint holds the
whole TSM-ResNet, TAP-Net runs it to unit_2) is dropped, as Flax ignores
it. `state_dict_to_tapnet` and `stats_to_flax` are the inverses.

TRAJAN (`trajan_to_state_dict`, `load_trajan_params`) takes the Flax tree
of `trajan.track_autoencoder.TrackAutoEncoder`: the attention projections'
DenseGeneral kernels [D, heads, head_dim] -> `weight` [heads*head_dim, D],
`dense_out`'s [heads, head_dim, D] -> [D, heads*head_dim], Dense kernels
transposed, and norm scales, biases and the latent bank `state_init`
unchanged.

`state_dict_to_flax` and `state_dict_to_tapnext` are the inverses for
TAPIR and TAPNext: it turns the port's
tensors (parameters, or anything of their shapes and names: gradients,
optimizer moments) back into the Flax-layout tree, which training
checkpoints store and the JAX package reads. `tapnext_flax_path` gives the
Flax path of a port parameter name: `weight` is Flax's `kernel`, every other
leaf keeps its name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_PLAIN_LEAVES = ("bias", "scale", "offset")


def _walk(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _walk(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Converts a Flax TAPIR param tree (numpy leaves) to state_dict tensors."""
  out: Dict[str, torch.Tensor] = {}
  for path, value in _walk(params):
    arr = np.asarray(value)
    if arr.dtype == np.float16:
      arr = arr.astype(np.float32)
    leaf = path[-1]
    if leaf == "kernel":
      if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
      elif arr.ndim == 2:
        arr = arr.T
      elif arr.ndim != 3:
        raise ValueError(f"Unmapped kernel rank {arr.ndim} at {'/'.join(path)}")
      leaf = "weight"
    elif leaf not in _PLAIN_LEAVES:
      raise ValueError(f"Unmapped parameter leaf: {'/'.join(path)}")
    key = ".".join(path[:-1] + (leaf,))
    out[key] = torch.from_numpy(np.ascontiguousarray(arr))
  return out


_TAPNEXT_PLAIN_LEAVES = (
    "bias", "scale", "w", "b", "a_param", "mask_token", "unknown_token",
    "point_query_token", "pos_embedding", "pos_embedding_full",
)
_ATTENTION_INPUTS = ("query", "key", "value")


def tapnext_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Converts a Flax TAPNext param tree (numpy leaves) to state_dict
  tensors."""
  out: Dict[str, torch.Tensor] = {}
  for path, value in _walk(params):
    arr = np.asarray(value)
    if arr.dtype == np.float16:
      arr = arr.astype(np.float32)
    leaf, module = path[-1], path[-2] if len(path) > 1 else ""
    where = "/".join(path)
    if leaf == "kernel":
      if module in _ATTENTION_INPUTS and arr.ndim == 3:
        arr = arr.reshape(arr.shape[0], -1).T
      elif module == "out" and arr.ndim == 3:
        arr = arr.reshape(-1, arr.shape[-1]).T
      elif module == "embedding" and arr.ndim == 5:
        arr = arr.reshape(-1, arr.shape[-1]).T
      elif arr.ndim == 2:
        arr = arr.T
      else:
        raise ValueError(f"Unmapped kernel of rank {arr.ndim} at {where}")
      leaf = "weight"
    elif leaf == "bias" and module in _ATTENTION_INPUTS and arr.ndim == 2:
      arr = arr.reshape(-1)
    elif leaf not in _TAPNEXT_PLAIN_LEAVES:
      raise ValueError(f"Unmapped parameter leaf: {where}")
    key = ".".join(path[:-1] + (leaf,))
    out[key] = torch.from_numpy(np.ascontiguousarray(arr))
  return out


def tapnext_flax_path(name: str) -> Tuple[str, ...]:
  """The Flax path of a TAPNext (or TAPIR) state_dict key."""
  path = tuple(name.split("."))
  return path[:-1] + ("kernel",) if path[-1] == "weight" else path


def state_dict_to_tapnext(tensors: Mapping[str, torch.Tensor],
                          num_heads: int,
                          patch_size: Tuple[int, int, int]) -> Dict[str, Any]:
  """The inverse of `tapnext_to_state_dict`: TAPNext tensors under the
  port's names (any device) -> the Flax-layout tree of numpy leaves."""
  tree: Dict[str, Any] = {}
  _, ph, pw = patch_size
  for name, value in tensors.items():
    arr = value.detach().cpu().numpy()
    path = tapnext_flax_path(name)
    leaf, module = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
      if module in _ATTENTION_INPUTS:
        arr = arr.T.reshape(arr.shape[1], num_heads, -1)
      elif module == "out" and "MultiHeadDotProductAttention_0" in path:
        arr = arr.T.reshape(num_heads, -1, arr.shape[0])
      elif module == "embedding":
        arr = arr.T.reshape(1, ph, pw, -1, arr.shape[0])
      else:
        arr = arr.T
    elif leaf == "bias" and module in _ATTENTION_INPUTS:
      arr = arr.reshape(num_heads, -1)
    elif leaf not in _TAPNEXT_PLAIN_LEAVES:
      raise ValueError(f"Unmapped parameter: {name}")
    node = tree
    for part in path[:-1]:
      node = node.setdefault(part, {})
    node[leaf] = np.ascontiguousarray(arr)
  return tree


def load_tapnext_params(model: nn.Module, params: Mapping[str, Any]) -> None:
  """Fills every parameter of a `models.tapnext.TAPNextTracker` (or of one of
  its modules, from the matching subtree) from a Flax TAPNext tree, or
  raises."""
  _load_converted(model, tapnext_to_state_dict(params))


def state_dict_to_flax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """The inverse of `flax_to_state_dict`: TAPIR tensors under the port's
  names (parameters, or anything of their shapes and names: gradients,
  optimizer moments; any device) -> the Flax-layout tree of numpy leaves."""
  tree: Dict[str, Any] = {}
  for name, value in tensors.items():
    arr = value.detach().cpu().numpy()
    path = tapnext_flax_path(name)
    leaf = path[-1]
    if leaf == "kernel":
      if arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)
      elif arr.ndim == 2:
        arr = arr.T
    elif leaf not in _PLAIN_LEAVES:
      raise ValueError(f"Unmapped parameter: {name}")
    node = tree
    for part in path[:-1]:
      node = node.setdefault(part, {})
    node[leaf] = np.ascontiguousarray(arr)
  return tree


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
  """Fills every parameter of `model` from a Flax TAPIR tree, or raises."""
  _load_converted(model, flax_to_state_dict(params))


def _load_converted(model: nn.Module, converted: Dict[str, torch.Tensor]):
  expected = model.state_dict()
  unknown = sorted(set(converted) - set(expected))
  if unknown:
    raise ValueError(f"Checkpoint leaves with no model parameter: {unknown}")
  missing = sorted(set(expected) - set(converted))
  if missing:
    raise ValueError(f"Model parameters left unfilled: {missing}")
  for key, tensor in converted.items():
    if tuple(tensor.shape) != tuple(expected[key].shape):
      raise ValueError(
          f"Shape mismatch at {key}: checkpoint {tuple(tensor.shape)} vs "
          f"model {tuple(expected[key].shape)}"
      )
  model.load_state_dict(converted, strict=True)


def _without_frame_axis(params: Mapping[str, Any]) -> Dict[str, Any]:
  """The tree with TAP-Net heads' (1, 3, 3, C_in, C_out) kernels as HWIO."""
  out: Dict[str, Any] = {}
  for key, value in params.items():
    if isinstance(value, Mapping):
      out[key] = _without_frame_axis(value)
    else:
      arr = np.asarray(value)
      out[key] = arr[0] if key == "kernel" and arr.ndim == 5 else arr
  return out


def tapnet_to_state_dict(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
  """Converts Flax TAP-Net (params, batch_stats) trees to state_dict
  tensors (parameters and running statistics)."""
  return _with_batch_stats(flax_to_state_dict(_without_frame_axis(params)),
                           batch_stats)


def _with_batch_stats(out: Dict[str, torch.Tensor],
                      batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """`out` with Flax's BatchNorm running statistics (`mean`, `var` leaves of
  a `batch_stats` tree) added under the same names."""
  for path, value in _walk(batch_stats):
    if path[-1] not in ("mean", "var"):
      raise ValueError(f"Unmapped batch statistic: {'/'.join(path)}")
    out[".".join(path)] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(value, np.float32)))
  return out


def load_resnet_params(model: nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any] = None) -> None:
  """Fills every parameter and BatchNorm running statistic of a
  `models.resnet.ResNet` from Flax's `params` (and `batch_stats`) trees of
  the JAX package's ResNet, or raises."""
  _load_converted(model, _with_batch_stats(flax_to_state_dict(params),
                                           batch_stats or {}))


def load_tapnet_params(model: nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> None:
  """Fills every parameter and running statistic of a
  `models.tapnet.TAPNet` (or of its backbone alone, from the `backbone`
  subtrees) from Flax trees, or raises."""
  converted = tapnet_to_state_dict(params, batch_stats)
  built = {k.split(".")[1] for k in model.state_dict() if k.startswith("backbone.")}
  converted = {k: v for k, v in converted.items()
               if not k.startswith("backbone.") or k.split(".")[1] in built}
  _load_converted(model, converted)


def state_dict_to_tapnet(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """The inverse of `tapnet_to_state_dict` for TAP-Net parameters (or
  gradients, optimizer moments): the Flax-layout tree, the heads' kernels
  with their frame axis."""
  tree = state_dict_to_flax(tensors)
  for module in tree.get("heads", {}).values():
    if "kernel" in module and module["kernel"].ndim == 4:
      module["kernel"] = module["kernel"][None]
  return tree


def stats_to_flax(buffers: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """TAP-Net running statistics by name -> Flax's `batch_stats` tree."""
  tree: Dict[str, Any] = {}
  for name, value in buffers.items():
    node = tree
    path = name.split(".")
    for part in path[:-1]:
      node = node.setdefault(part, {})
    node[path[-1]] = value.detach().cpu().numpy()
  return tree


_TRAJAN_QKV = ("dense_query", "dense_key", "dense_value")
_TRAJAN_PLAIN_LEAVES = ("bias", "scale", "state_init")


def trajan_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Converts a Flax TRAJAN param tree (numpy leaves) to state_dict
  tensors."""
  out: Dict[str, torch.Tensor] = {}
  for path, value in _walk(params):
    arr = np.asarray(value, np.float32)
    leaf, module = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
      if module in _TRAJAN_QKV and arr.ndim == 3:
        arr = arr.reshape(arr.shape[0], -1).T
      elif module == "dense_out" and arr.ndim == 3:
        arr = arr.reshape(-1, arr.shape[-1]).T
      elif arr.ndim == 2:
        arr = arr.T
      else:
        raise ValueError(f"Unmapped kernel of rank {arr.ndim} at "
                         f"{'/'.join(path)}")
      leaf = "weight"
    elif leaf not in _TRAJAN_PLAIN_LEAVES:
      raise ValueError(f"Unmapped parameter leaf: {'/'.join(path)}")
    out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
        np.ascontiguousarray(arr))
  return out


def load_trajan_params(model: nn.Module, params: Mapping[str, Any]) -> None:
  """Fills every parameter of a `trajan.track_autoencoder.TrackAutoEncoder`
  from a Flax TRAJAN tree, or raises."""
  _load_converted(model, trajan_to_state_dict(params))
