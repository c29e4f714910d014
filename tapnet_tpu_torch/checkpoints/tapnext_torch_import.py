"""Import released PyTorch TAPNext checkpoints (.pt/.ckpt) as a Flax-layout
tree (the port's own copy of tapnet_tpu/checkpoints/tapnext_torch_import.py).

TAPNext++ weights are released ONLY as torch state dicts
(`tapnextpp_ckpt.pt`, `tapnextpp_512.ckpt` — reference
tapnet/tapnextpp/README.md), in the reference torch module layout. This is
the exact inverse of the reference's JAX -> torch mapping
(tapnet/tapnext/tapnext_torch_utils.py:60-204 /
convert_pytorch_model_to_jax_checkpoint :207-361): the state dict is
rewritten to the released flat-npz key convention, then unflattened
(`tapnext_checkpoint.unflatten`) into the tree that
`checkpoints.convert.load_tapnext_params` loads into the port's
`TAPNextTracker`.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints import tapnext_checkpoint


def _to_np(v) -> np.ndarray:
  if hasattr(v, "detach"):  # torch tensor
    v = v.detach().cpu().numpy()
  return np.asarray(v)


def state_dict_to_flat_jax(
    sd: Mapping[str, Any], num_heads: int = 12
) -> Dict[str, np.ndarray]:
  """torch TAPNext state dict -> flat JAX checkpoint keys.

  Args:
    sd: state dict with reference torch module names (`lin_proj.*`,
      `blocks.{i}.ssm_block.*`, `blocks.{i}.vit_block.*`, heads).
    num_heads: attention heads (12 for ViT-B).

  Returns:
    {released-npz key: array}, loadable by tapnext_checkpoint.unflatten.
  """
  sd = {k: _to_np(v) for k, v in sd.items()}
  out: Dict[str, np.ndarray] = {}

  # --- global embeddings ---
  # torch conv kernel (Out, In, kh, kw) -> Flax (1, kh, kw, In, Out).
  out["backbone/embedding/kernel"] = sd["lin_proj.weight"].transpose(
      2, 3, 1, 0
  )[None]
  out["backbone/embedding/bias"] = sd["lin_proj.bias"]
  out["backbone/mask_token"] = sd["mask_token"]
  out["backbone/point_query_token"] = sd["point_query_token"]
  out["backbone/unknown_token"] = sd["unknown_token"]
  out["backbone/pos_embedding"] = sd["image_pos_emb"]
  out["backbone/Transformer/encoder_norm/scale"] = sd["encoder_norm.weight"]
  out["backbone/Transformer/encoder_norm/bias"] = sd["encoder_norm.bias"]

  layers = sorted(
      {
          int(k.split(".")[1])
          for k in sd
          if k.startswith("blocks.")
      }
  )
  for layer in layers:
    prefix = f"backbone/Transformer/encoderblock_{layer}"

    # --- SSM block: generic rule (dots -> slashes, weight -> kernel with
    # transpose; 1-D "weight" params like RMSNorm scales are unaffected
    # by .T).
    ssm_prefix = f"blocks.{layer}.ssm_block."
    for k, v in sd.items():
      if not k.startswith(ssm_prefix):
        continue
      suffix = k[len(ssm_prefix):]
      jax_suffix = suffix.replace(".", "/").replace("weight", "kernel")
      if "weight" in suffix:
        v = v.T
      out[f"{prefix}/ssm_block/{jax_suffix}"] = v

    # --- ViT block ---
    vp = f"blocks.{layer}.vit_block."
    vj = f"{prefix}/vit_block"
    out[f"{vj}/LayerNorm_0/scale"] = sd[vp + "ln_1.weight"]
    out[f"{vj}/LayerNorm_0/bias"] = sd[vp + "ln_1.bias"]
    out[f"{vj}/LayerNorm_1/scale"] = sd[vp + "ln_2.weight"]
    out[f"{vj}/LayerNorm_1/bias"] = sd[vp + "ln_2.bias"]
    out[f"{vj}/MlpBlock_0/Dense_0/kernel"] = sd[vp + "mlp.0.weight"].T
    out[f"{vj}/MlpBlock_0/Dense_0/bias"] = sd[vp + "mlp.0.bias"]
    out[f"{vj}/MlpBlock_0/Dense_1/kernel"] = sd[vp + "mlp.3.weight"].T
    out[f"{vj}/MlpBlock_0/Dense_1/bias"] = sd[vp + "mlp.3.bias"]

    in_w = sd[vp + "self_attention.in_proj_weight"]  # (3E, E)
    in_b = sd[vp + "self_attention.in_proj_bias"]  # (3E,)
    embed = in_w.shape[1]
    head_dim = embed // num_heads
    qw, kw, vw = np.split(in_w, 3, axis=0)
    qb, kb, vb = np.split(in_b, 3, axis=0)
    attn = f"{vj}/MultiHeadDotProductAttention_0"
    for name, w, b in (("query", qw, qb), ("key", kw, kb),
                       ("value", vw, vb)):
      out[f"{attn}/{name}/kernel"] = w.T.reshape(embed, num_heads, head_dim)
      out[f"{attn}/{name}/bias"] = b.reshape(num_heads, head_dim)
    out[f"{attn}/out/kernel"] = (
        sd[vp + "self_attention.out_proj.weight"].T.reshape(
            num_heads, head_dim, embed
        )
    )
    out[f"{attn}/out/bias"] = sd[vp + "self_attention.out_proj.bias"]

  # --- prediction heads: Sequential indices {0,3,6}=Linear, {1,4}=Norm.
  for head in ("visible_head", "coordinate_head"):
    for idx in (0, 3, 6):
      out[f"{head}/layers_{idx}/kernel"] = sd[f"{head}.{idx}.weight"].T
      out[f"{head}/layers_{idx}/bias"] = sd[f"{head}.{idx}.bias"]
    for idx in (1, 4):
      out[f"{head}/layers_{idx}/scale"] = sd[f"{head}.{idx}.weight"]
      out[f"{head}/layers_{idx}/bias"] = sd[f"{head}.{idx}.bias"]

  return out


def _extract_state_dict(obj) -> Mapping[str, Any]:
  """Accepts a raw state dict or common checkpoint wrappers."""
  if hasattr(obj, "state_dict"):  # a live torch module
    obj = obj.state_dict()
  for key in ("state_dict", "model", "module"):
    if isinstance(obj, Mapping) and key in obj and isinstance(
        obj[key], Mapping
    ):
      obj = obj[key]
  # Strip DataParallel-style ("module.") and Lightning-style ("model.")
  # wrapper prefixes.
  out = dict(obj)
  for prefix in ("module.", "model."):
    if out and all(k.startswith(prefix) for k in out):
      out = {k[len(prefix):]: v for k, v in out.items()}
  return out


def load_tapnext_torch_checkpoint(
    path: str, num_heads: int = 12, allow_pickle: bool = False
) -> Dict[str, Any]:
  """Loads a released torch TAPNext/TAPNext++ checkpoint as a Flax-layout
  tree with numpy leaves (`inference.TapnextPredictor` takes it).

  `allow_pickle=True` falls back to `torch.load(weights_only=False)` for
  checkpoints with non-tensor metadata (e.g. Lightning `.ckpt` files) —
  only use it on files you trust, as it runs arbitrary pickled code.
  """
  try:
    obj = torch.load(path, map_location="cpu", weights_only=True)
  except pickle.UnpicklingError as e:
    if not allow_pickle:
      raise ValueError(
          f"{path} could not be loaded with weights_only=True (it likely "
          "contains non-tensor metadata, e.g. a Lightning .ckpt). If you "
          "trust this file, retry with allow_pickle=True."
      ) from e
    obj = torch.load(path, map_location="cpu", weights_only=False)
  flat = state_dict_to_flat_jax(_extract_state_dict(obj), num_heads)
  return tapnext_checkpoint.unflatten(flat)
