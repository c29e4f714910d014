"""Seed-made TRAJAN weights in the Flax layout (numpy only).

No TRAJAN checkpoint is in the repository, so the port's TRAJAN checks run
on weights made here from a seed. `seeded_trajan_params(seed, **model)`
returns the parameter tree of `trajan.track_autoencoder.TrackAutoEncoder
(**model)` (the JAX package's; its defaults are the published widths),
which the JAX package takes as it is (`model.apply({"params": tree}, ...)`)
and the port through `checkpoints.convert.load_trajan_params`.

Scales follow the Flax initializers of the JAX modules, so activations stay
in range through the 15 transformer layers: LeCun (fan-in) truncated
normals for every Dense and DenseGeneral kernel (fan-in: the contracted
input axes), a unit normal for the latent bank `state_init`. Where Flax
starts at zero or one (biases, norm scales), the values here are small
perturbations of it (0.02 standard deviations), so that every parameter
takes part in a check.
"""

from __future__ import annotations

from typing import Any, Dict

from tools.tapnext_weights import _Maker

# TrackAutoEncoder's defaults (tapnet_tpu/trajan/track_autoencoder.py).
DEFAULTS = dict(num_output_frames=150, num_latent_tokens=128,
                latent_token_dim=64, num_frequencies=32, track_token_dim=256,
                encoder_latent_dim=512, decoder_num_channels=1024,
                time_feat_dim=128)
# The transformers' (qkv_size, num_heads, mlp_size, num_layers).
TRANSFORMERS = dict(input_track_transformer=(512, 8, 1024, 2),
                    tracks_to_latents=(512, 8, 2048, 6),
                    decompress_attn=(512, 8, 2048, 3),
                    track_readout_attn=(512, 8, 1024, 4))


def _attention(m: _Maker, width, kv_width, qkv, heads):
  hd = qkv // heads
  return {
      "dense_query": {"kernel": m.truncated((width, heads, hd), 1.0, width)},
      "dense_key": {"kernel": m.truncated((kv_width, heads, hd), 1.0,
                                          kv_width)},
      "norm_query": {"scale": m.near((hd,), 1.0)},
      "norm_key": {"scale": m.near((hd,), 1.0)},
      "dense_value": {"kernel": m.truncated((kv_width, heads, hd), 1.0,
                                            kv_width)},
      "dense_out": {"kernel": m.truncated((heads, hd, width), 1.0, qkv),
                    "bias": m.near((width,), 0.0)},
  }


def _transformer(m: _Maker, width, spec, kv_width=None):
  qkv, heads, mlp, layers = spec
  tree = {}
  for i in range(layers):
    block = {"norm_q": {"scale": m.near((width,), 1.0)},
             "self_att": _attention(m, width, width, qkv, heads)}
    if kv_width is not None:
      block["cross_att"] = _attention(m, width, kv_width, qkv, heads)
    block.update(norm_attn={"scale": m.near((width,), 1.0)},
                 MLP_in=m.dense(width, mlp), MLP_out=m.dense(mlp, width))
    tree[f"layer_{i}"] = block
  tree["norm_encoder"] = {"scale": m.near((width,), 1.0)}
  return tree


def seeded_trajan_params(seed: int = 0, **model) -> Dict[str, Any]:
  """The TrackAutoEncoder(**model) parameter tree, made from `seed`."""
  cfg = dict(DEFAULTS, **{k: v for k, v in model.items() if k in DEFAULTS})
  m = _Maker(seed)
  emb = 2 * cfg["num_frequencies"]
  token, latent = cfg["track_token_dim"], cfg["encoder_latent_dim"]
  channels = cfg["decoder_num_channels"]
  latent_width = channels - cfg["time_feat_dim"]
  return {
      "initializer": {"state_init": m.normal(
          (cfg["num_latent_tokens"], latent), 1.0)},
      "track_token_projection": m.dense(3 * emb, token),
      "compressor": m.dense(latent, cfg["latent_token_dim"]),
      "decompressor": m.dense(cfg["latent_token_dim"], latent_width),
      "input_track_transformer": _transformer(
          m, token, TRANSFORMERS["input_track_transformer"]),
      "tracks_to_latents": _transformer(
          m, latent, TRANSFORMERS["tracks_to_latents"], kv_width=token),
      "decompress_attn": _transformer(m, latent_width,
                                      TRANSFORMERS["decompress_attn"]),
      "track_readout_attn": _transformer(m, channels,
                                         TRANSFORMERS["track_readout_attn"]),
      "query_encoder": m.dense((2 * emb + 1) * emb, channels),
      "track_predictor": m.dense(channels, cfg["num_output_frames"] * 4),
  }
