"""Seed-made TAPNext weights in the released checkpoint layout (numpy only).

No TAPNext checkpoint is in the repository, so the port's TAPNext checks run
on weights made here from a seed. `seeded_tapnext_params(config, seed)`
returns the nested parameter tree of the released flat keys
(`backbone/Transformer/encoderblock_{i}/...`, as
`checkpoints/tapnext_checkpoint.load_tapnext_checkpoint` returns it), which
both the JAX package (`model.apply({"params": tree}, ...)`) and the port
(`checkpoints.convert.load_tapnext_params`) take.

Scales follow the Flax initializers of the JAX modules, so activations stay
in range through 12 layers: LeCun (fan-in) truncated normals for the dense,
patch-embedding and block-diagonal kernels, Xavier-uniform for the ViT
blocks, 2/depth fan-in variance for the two output projections of each SSM
block, 0.01 fan-in variance for the temporal conv, the Griffin `a_param`
(a uniform in [0.9, 0.999]) and normal(1/sqrt(width)) tokens and position
embeddings. Where Flax starts at zero or one (biases, norm scales), the
values here are small perturbations of it (0.02 standard deviations), so
that every parameter takes part in a check. The truncated normal is a normal
clipped at two deviations and scaled as Flax scales its truncated normal.

`config` is any object with the fields of `SsmVitConfig` (the JAX package's
or the port's).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

# Flax's truncated normal divides its deviation by the deviation of a unit
# normal truncated at +-2.
_TRUNC_STD = 0.87962566103423978
_SMALL = 0.02


class _Maker:
  """Draws every array from one generator, in the order they are asked for."""

  def __init__(self, seed: int):
    self.rng = np.random.default_rng(seed)

  def normal(self, shape, std):
    out = self.rng.standard_normal(shape, dtype=np.float32)
    out *= np.float32(std)
    return out

  def truncated(self, shape, variance, fan_in):
    out = self.rng.standard_normal(shape, dtype=np.float32)
    np.clip(out, -2.0, 2.0, out=out)
    out *= np.float32(np.sqrt(variance / fan_in) / _TRUNC_STD)
    return out

  def xavier(self, shape, fan_in, fan_out):
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return self.rng.uniform(-limit, limit, shape).astype(np.float32)

  def near(self, shape, value):
    return value + self.normal(shape, _SMALL)

  def dense(self, fan_in, fan_out, variance=1.0):
    return {"kernel": self.truncated((fan_in, fan_out), variance, fan_in),
            "bias": self.near((fan_out,), 0.0)}

  def layer_norm(self, width):
    return {"scale": self.near((width,), 1.0), "bias": self.near((width,), 0.0)}


def _ssm_block(m: _Maker, width, mlp_dim, lru_width, num_heads, depth):
  bw = lru_width // num_heads
  final = 2.0 / depth
  u = m.rng.uniform(0.9, 0.999, (lru_width,))
  a_param = np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
  gate = lambda: {"w": m.truncated((num_heads, bw, bw), 1.0, bw),
                  "b": m.near((num_heads, bw), 0.0)}
  return {
      "temporal_pre_norm": {"scale": m.near((width,), 0.0)},
      "recurrent_block": {
          "linear_y": m.dense(width, lru_width),
          "linear_x": m.dense(width, lru_width),
          "conv_1d": {"w": m.truncated((4, lru_width), 0.01, 4),
                      "b": m.near((lru_width,), 0.0)},
          "rg_lru": {"a_param": a_param, "input_gate": gate(),
                     "a_gate": gate()},
          "linear_out": m.dense(lru_width, width, final),
      },
      "channel_pre_norm": {"scale": m.near((width,), 0.0)},
      "mlp_block": {
          "ffw_up": {"w": m.truncated((2, width, mlp_dim), 1.0, width),
                     "b": m.near((2, 1, 1, mlp_dim), 0.0)},
          "ffw_down": m.dense(mlp_dim, width, final),
      },
  }


def _vit_block(m: _Maker, width, mlp_dim, num_heads):
  hd = width // num_heads
  qkv = lambda: {"kernel": m.xavier((width, num_heads, hd), width, width),
                 "bias": m.near((num_heads, hd), 0.0)}
  return {
      "LayerNorm_0": m.layer_norm(width),
      "MultiHeadDotProductAttention_0": {
          "query": qkv(), "key": qkv(), "value": qkv(),
          "out": {"kernel": m.xavier((num_heads, hd, width), width, width),
                  "bias": m.near((width,), 0.0)},
      },
      "LayerNorm_1": m.layer_norm(width),
      "MlpBlock_0": {
          "Dense_0": {"kernel": m.xavier((width, mlp_dim), width, mlp_dim),
                      "bias": m.normal((mlp_dim,), 1e-6)},
          "Dense_1": {"kernel": m.xavier((mlp_dim, width), mlp_dim, width),
                      "bias": m.normal((width,), 1e-6)},
      },
  }


def _head(m: _Maker, width, out_features, inner=256):
  return {"layers_0": m.dense(width, inner), "layers_1": m.layer_norm(inner),
          "layers_3": m.dense(inner, inner), "layers_4": m.layer_norm(inner),
          "layers_6": m.dense(inner, out_features)}


def seeded_tapnext_params(config, seed: int = 0) -> Dict[str, Any]:
  """The TAPNextTracker parameter tree for `config`, made from `seed`."""
  m = _Maker(seed)
  c = config.width
  mlp_dim = config.mlp_dim or 4 * c
  ssm_width = 2 * c if config.bidirectional_ssm else c
  lru_width = config.lru_width or ssm_width
  _, ph, pw = config.patch_size
  h = config.image_size[0] // ph
  w = config.image_size[1] // pw
  token_std = 1.0 / np.sqrt(c)

  transformer = {}
  for lyr in range(config.depth):
    transformer[f"encoderblock_{lyr}"] = {
        "ssm_block": _ssm_block(m, ssm_width, mlp_dim, lru_width,
                                config.num_heads, config.depth),
        "vit_block": _vit_block(m, c, mlp_dim, config.num_heads),
    }
  transformer["encoder_norm"] = m.layer_norm(c)
  backbone = {
      "embedding": {"kernel": m.truncated((1, ph, pw, 3, c), 1.0, ph * pw * 3),
                    "bias": m.near((c,), 0.0)},
      "Transformer": transformer,
      "mask_token": m.normal((1, 1, 1, c), token_std),
      "unknown_token": m.normal((1, 1, c), token_std),
      "point_query_token": m.normal((1, 1, 1, c), token_std),
  }
  if config.posemb == "learn":
    backbone["pos_embedding"] = m.normal((1, h * w, c), token_std)
  if config.posemb_full == "learn":
    full = config.image_size[0] * config.image_size[1] * config.query_scale**2
    backbone["pos_embedding_full"] = m.normal((1, full, c), token_std)
  return {"backbone": backbone, "visible_head": _head(m, c, 1),
          "coordinate_head": _head(m, c, 512)}
