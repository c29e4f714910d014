"""TRAJAN: point-trajectory autoencoder (port of
tapnet_tpu/trajan/track_autoencoder.py).

Support tracks are embedded with sinusoidal features, summarized per track
by a small transformer with visibility-masked mean pooling, cross-attended
into 128 latent tokens (dim 64, straight-through quantized with dither),
and decoded per query point by a cross-attention readout that emits
`num_output_frames` frames of (x, y) and visible/certain logits.

Conventions, as in the JAX version: tracks are normalized (x, y) in
[0, 1]; query points are (t, x, y); outputs are (x, y).

Where the JAX version differs from plain PyTorch, the port follows it:
  * the time-conditioning window `_append_time_feat` starts at
    5 * query_frame clamped into [0, C - time_feat_dim], as
    `lax.dynamic_slice` clamps (a torch index does not);
  * the time feature is `query_frame // time_scale_factor`, the floor of an
    int divided by a float;
  * the decoder's dither is uniform noise in [0, 1), which JAX draws from
    `PRNGKey(0)` when no key is given. The port cannot draw JAX's numbers:
    `decode` and `forward` take the noise as a tensor (a test feeds JAX's
    draw) or draw it from a `torch.Generator`. The straight-through form
    `latents - (latents - quant).detach()` passes the gradient through.
  * `decoder_chunk_size` decodes the queries in chunks (JAX's `nn.scan`), a
    loop here, every chunk with the same latents and the same noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional

import torch
from torch import nn

from tapnet_tpu_torch.models.tapir import lecun_normal
from tapnet_tpu_torch.trajan import attention


class SinusoidalEmbedding(nn.Module):
  """Fourier features: per coordinate, the sines then the cosines of the
  coordinate times 2^(i/3), i < num_frequencies."""

  def __init__(self, num_frequencies: int):
    super().__init__()
    self.register_buffer("scales", torch.tensor(
        [2 ** (i / 3) for i in range(num_frequencies)], dtype=torch.float32),
                         persistent=False)

  def forward(self, inputs: torch.Tensor) -> torch.Tensor:
    x = inputs[..., None] * self.scales
    out = torch.sin(torch.cat([x, x + 0.5 * math.pi], -1))
    return out.reshape(out.shape[:-2] + (-1,))


class ParamStateInit(nn.Module):
  """Learnable token bank broadcast over the batch."""

  def __init__(self, shape):
    super().__init__()
    self.state_init = nn.Parameter(torch.empty(shape))

  def forward(self, batch_shape) -> torch.Tensor:
    return self.state_init.expand(tuple(batch_shape) + self.state_init.shape)


@dataclasses.dataclass
class TrackAutoEncoderResults:
  tracks: torch.Tensor  # [*B, Q, T, 2]
  visible_logits: torch.Tensor  # [*B, Q, T, 1]
  certain_logits: torch.Tensor  # [*B, Q, T, 1]

  @property
  def visible(self) -> torch.Tensor:
    return (self.visible_logits > 0).float()

  @property
  def certain(self) -> torch.Tensor:
    return (self.certain_logits > 0).float()

  @property
  def visible_and_certain(self) -> torch.Tensor:
    return (torch.sigmoid(self.visible_logits)
            * torch.sigmoid(self.certain_logits) > 0.5).float()


class DecoderContext(NamedTuple):
  decoder_query: torch.Tensor  # [*B, Q, features]
  query_frame: torch.Tensor  # [*B, Q] int
  boundary_frame: Optional[torch.Tensor]  # [*B]


class TrackAutoEncoder(nn.Module):
  """Trajectory autoencoder. Inputs dict: support_tracks [B, Q, T, 2],
  support_tracks_visible [B, Q, T, 1], boundary_frame [B] (the first padded
  frame), optional query_points [B, Q', 3] as (t, x, y) (default: a 32 x 32
  grid of cell centres at t = 0)."""

  def __init__(self, num_output_frames: int = 150,
               num_latent_tokens: int = 128, latent_token_dim: int = 64,
               num_frequencies: int = 32, track_scale_factor: float = 1.0,
               time_scale_factor: float = 150.0, track_token_dim: int = 256,
               encoder_latent_dim: int = 512,
               decoder_num_channels: int = 1024,
               decoder_chunk_size: Optional[int] = None,
               time_feat_dim: int = 128):
    super().__init__()
    self.num_output_frames = num_output_frames
    self.track_scale_factor = track_scale_factor
    self.time_scale_factor = time_scale_factor
    self.decoder_chunk_size = decoder_chunk_size
    self.time_feat_dim = time_feat_dim
    emb = 2 * num_frequencies
    latent_width = decoder_num_channels - time_feat_dim
    self.initializer = ParamStateInit((num_latent_tokens, encoder_latent_dim))
    self.track_token_projection = nn.Linear(3 * emb, track_token_dim)
    self.sinusoidal_embedding = SinusoidalEmbedding(num_frequencies)
    self.compressor = nn.Linear(encoder_latent_dim, latent_token_dim)
    self.decompressor = nn.Linear(latent_token_dim, latent_width)
    self.input_track_transformer = attention.ImprovedTransformer(
        track_token_dim, qkv_size=512, num_heads=8, mlp_size=1024,
        num_layers=2)
    self.tracks_to_latents = attention.ImprovedTransformer(
        encoder_latent_dim, qkv_size=512, num_heads=8, mlp_size=2048,
        num_layers=6, kv_width=track_token_dim)
    self.decompress_attn = attention.ImprovedTransformer(
        latent_width, qkv_size=512, num_heads=8, mlp_size=2048, num_layers=3)
    self.track_readout_attn = attention.ImprovedTransformer(
        decoder_num_channels, qkv_size=512, num_heads=8, mlp_size=1024,
        num_layers=4)
    # The query's (x, y) embedding and its time feature, embedded again.
    self.query_encoder = nn.Linear((2 * emb + 1) * emb, decoder_num_channels)
    self.track_predictor = nn.Linear(decoder_num_channels,
                                     num_output_frames * 4)

  # ------------------------------------------------------------------ encode

  def embed_track_pos_visible(self, tracks: torch.Tensor,
                              visible: torch.Tensor) -> torch.Tensor:
    """Sinusoidal embedding of (x, y, t/T) per track sample."""
    t = tracks.shape[-2]
    fr = (torch.arange(t, dtype=torch.float32, device=tracks.device) / t)
    fr = fr[None, None, :, None].expand(visible.shape)
    feats = torch.cat([tracks, fr.to(tracks.dtype)], -1)
    return self.sinusoidal_embedding(feats / self.track_scale_factor)

  def encode_tracks(self, tracks: torch.Tensor, visible: torch.Tensor,
                    restart: torch.Tensor) -> torch.Tensor:
    """Per-track descriptor: a transformer over time, keys masked to the
    visible frames before `restart`, then visibility-weighted mean
    pooling."""
    tokens = self.track_token_projection(
        self.embed_track_pos_visible(tracks, visible))
    time = torch.arange(visible.shape[2], device=tracks.device)
    in_bounds = time < restart[..., None, None, None]  # [B, 1, 1, T]
    vis = visible[..., 0] != 0
    key_mask = vis[..., None, :].expand(vis.shape + vis.shape[-1:])
    tokens = self.input_track_transformer(tokens,
                                          qq_mask=in_bounds & key_mask)
    weights = vis[..., None].to(tokens.dtype)
    return (tokens * weights).sum(-2) / torch.clamp(weights.sum(-2), min=1.0)

  def encode(self, inputs: Mapping[str, Any]) -> torch.Tensor:
    """Support tracks -> [B, num_latent_tokens, latent_token_dim]."""
    track_tokens = self.encode_tracks(inputs["support_tracks"],
                                      inputs["support_tracks_visible"],
                                      inputs["boundary_frame"])
    latents = self.initializer((inputs["support_tracks"].shape[0],))
    return self.compressor(self.tracks_to_latents(latents, track_tokens))

  # ------------------------------------------------------------------ decode

  def get_decoder_context(self, inputs: Mapping[str, Any]) -> DecoderContext:
    if "query_points" in inputs:
      qp = inputs["query_points"]
      decoder_query = qp[..., 1:]
      query_frame = torch.round(qp[..., 0]).to(torch.int32)
    else:
      tracks = inputs["support_tracks"]
      centers = (torch.arange(32, dtype=torch.float32, device=tracks.device)
                 / 32.0 + 1.0 / 64.0)
      gy, gx = torch.meshgrid(centers, centers, indexing="ij")
      decoder_query = torch.stack([gx, gy], -1).reshape(-1, 2)
      decoder_query = decoder_query.expand(tracks.shape[:-3]
                                           + decoder_query.shape)
      query_frame = torch.zeros(decoder_query.shape[:-1], dtype=torch.int32,
                                device=tracks.device)
    return DecoderContext(
        decoder_query=self.sinusoidal_embedding(
            decoder_query / self.track_scale_factor),
        query_frame=query_frame,
        boundary_frame=inputs.get("boundary_frame"))

  def _append_time_feat(self, latents: torch.Tensor,
                        query_frame: torch.Tensor) -> torch.Tensor:
    """latents [*B, N, C], query_frame [*B, Q] -> [*B, Q, N, C +
    time_feat_dim]: each query's copy of the latents with the window of
    time_feat_dim channels from 5 * query_frame appended (the start
    clamped into [0, C - time_feat_dim])."""
    c = latents.shape[-1]
    start = torch.clamp(query_frame.long() * 5, 0, c - self.time_feat_dim)
    tiled = latents[..., None, :, :].expand(
        latents.shape[:-2] + query_frame.shape[-1:] + latents.shape[-2:])
    idx = start[..., None] + torch.arange(self.time_feat_dim,
                                          device=latents.device)
    idx = idx[..., None, :].expand(tiled.shape[:-1] + (self.time_feat_dim,))
    return torch.cat([tiled, torch.gather(tiled, -1, idx)], -1)

  def decode(self, latents: torch.Tensor, decoder_context: DecoderContext,
             discretize: bool = True, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> TrackAutoEncoderResults:
    """Latents and query context -> per-query tracks over
    num_output_frames. `noise`: the dither, uniform in [0, 1) of the
    latents' shape (drawn from `generator` when not given)."""
    latents = torch.clamp(latents, -1.0, 1.0)
    if discretize:
      quant = torch.round(latents * 128.0) / 128.0
      if noise is None:
        noise = torch.rand(latents.shape, generator=generator,
                           device=latents.device, dtype=latents.dtype)
      quant = quant + noise / 128.0 - 1.0 / 256.0
      latents = latents - (latents - quant).detach()
    latents = self.decompress_attn(self.decompressor(latents))

    frame_feat = torch.div(decoder_context.query_frame[..., None].float(),
                           self.time_scale_factor, rounding_mode="floor")
    queries = torch.cat([decoder_context.decoder_query, frame_feat], -1)
    query_tokens = self.query_encoder(
        self.sinusoidal_embedding(queries / self.track_scale_factor))
    tiled = self._append_time_feat(latents, decoder_context.query_frame)
    tokens = torch.cat([query_tokens[..., None, :], tiled], -2)
    out = self.track_predictor(self.track_readout_attn(tokens)[..., 0, :])
    t = self.num_output_frames
    return TrackAutoEncoderResults(
        tracks=torch.stack([out[..., :t], out[..., t:2 * t]], -1),
        visible_logits=out[..., 2 * t:3 * t, None],
        certain_logits=out[..., 3 * t:, None])

  def forward(self, inputs: Mapping[str, Any],
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None
              ) -> TrackAutoEncoderResults:
    """Encode, then decode (with dither) every query; `noise` or
    `generator` as in `decode`."""
    latents = self.encode(inputs)
    if noise is None:
      noise = torch.rand(latents.shape, generator=generator,
                         device=latents.device, dtype=latents.dtype)
    h = self.decoder_chunk_size
    if h is None:
      return self.decode(latents, self.get_decoder_context(inputs),
                         noise=noise)
    if "query_points" not in inputs:
      raise ValueError("chunked decoding needs query_points")
    qp = inputs["query_points"]
    if qp.shape[-2] % h:
      raise ValueError(f"{qp.shape[-2]} queries are not a multiple of "
                       f"decoder_chunk_size {h}")
    parts = [self.decode(latents, self.get_decoder_context(dict(
        query_points=qp[..., s:s + h, :],
        boundary_frame=inputs["boundary_frame"])), noise=noise)
             for s in range(0, qp.shape[-2], h)]
    return TrackAutoEncoderResults(*(
        torch.cat([getattr(p, f.name) for p in parts], -3)
        for f in dataclasses.fields(TrackAutoEncoderResults)))


def init_trajan_params(model: TrackAutoEncoder,
                       generator: torch.Generator) -> None:
  """Fills `model` with fresh weights from `generator` (a CPU generator),
  drawn as Flax's initialisers draw them: every kernel LeCun's truncated
  normal over its fan-in (its Linear's input width), biases 0, norm scales
  1, the latent bank a unit normal."""
  with torch.no_grad():
    for name, p in model.named_parameters():
      leaf = name.rsplit(".", 1)[-1]
      if leaf == "weight":
        fan_in = p.shape[1]
        p.copy_(torch.from_numpy(lecun_normal(tuple(p.shape[::-1]), fan_in,
                                              generator)).T)
      elif leaf == "state_init":
        p.copy_(torch.randn(p.shape, generator=generator))
      else:
        p.fill_(1.0 if leaf == "scale" else 0.0)
