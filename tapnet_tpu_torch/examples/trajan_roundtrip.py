"""TRAJAN demo on the port: compress point tracks to latent tokens and
reconstruct them (the counterpart of examples/trajan_roundtrip.py).

Encodes a set of (track, visibility) trajectories into quantized latent
tokens, then decodes each track's first position back into a full
trajectory; the autoencoder's reconstruction error doubles as a
motion-realism metric.

  python -m tapnet_tpu_torch.examples.trajan_roundtrip [--device cpu]
  python -m tapnet_tpu_torch.examples.trajan_roundtrip \\
      --checkpoint trajan.npy --num_tracks 64

The queries are TRAJAN's (t, x, y); the JAX example passes (t, y, x)
(`tracks[..., ::-1]`), which the port does not copy. `--checkpoint` is the
Flax parameter tree saved with `np.save` (loaded with
`allow_pickle`), converted by `checkpoints.convert.load_trajan_params`.
Without one the model is a small one with random weights (a pipeline demo,
as the JAX example's). Runs on the CUDA card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.inference import resolve_device
from tapnet_tpu_torch.trajan import track_autoencoder

# The JAX example's small model for random weights.
SMALL = dict(num_latent_tokens=8, latent_token_dim=16, encoder_latent_dim=64,
             track_token_dim=32, decoder_num_channels=256, time_feat_dim=128)


def synthetic_tracks(num_tracks, num_frames, seed=0, rng=None):
  """Smooth sinusoidal trajectories in normalized [0, 1] coordinates (the
  JAX example's), drawn from `rng` (by default a RandomState of `seed`)."""
  if rng is None:
    rng = np.random.RandomState(seed)
  t = np.linspace(0, 1, num_frames)[None]
  base = rng.rand(num_tracks, 2)
  amp = rng.rand(num_tracks, 2) * 0.2
  phase = rng.rand(num_tracks, 2) * 2 * np.pi
  freq = rng.randint(1, 4, (num_tracks, 2))
  tracks = np.stack(
      [base[:, i, None] + amp[:, i, None]
       * np.sin(2 * np.pi * freq[:, i, None] * t + phase[:, i, None])
       for i in range(2)], axis=-1).astype(np.float32)
  visible = (rng.rand(num_tracks, num_frames, 1) > 0.1).astype(np.float32)
  return np.clip(tracks, 0, 1), visible


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--checkpoint", default=None)
  p.add_argument("--num_tracks", type=int, default=8)
  p.add_argument("--num_frames", type=int, default=150)
  p.add_argument("--device", default=None,
                 help="torch device; default the CUDA card")
  args = p.parse_args(argv)
  device = resolve_device(args.device)

  tracks, visible = synthetic_tracks(args.num_tracks, args.num_frames)
  query_points = np.concatenate(
      [np.zeros((1, args.num_tracks, 1), np.float32), tracks[None, :, 0]], -1)
  inputs = {
      "support_tracks": torch.from_numpy(tracks[None]),
      "support_tracks_visible": torch.from_numpy(visible[None]),
      "boundary_frame": torch.full((1,), args.num_frames, dtype=torch.int32),
      # Decode queries: each track's first position, (t, x, y).
      "query_points": torch.from_numpy(query_points),
  }
  inputs = {k: v.to(device) for k, v in inputs.items()}

  if args.checkpoint and os.path.exists(args.checkpoint):
    model = track_autoencoder.TrackAutoEncoder(
        num_output_frames=args.num_frames)
    convert.load_trajan_params(
        model, np.load(args.checkpoint, allow_pickle=True).item())
  else:
    print("no checkpoint — RANDOM weights (pipeline demo only)")
    model = track_autoencoder.TrackAutoEncoder(
        num_output_frames=args.num_frames, **SMALL)
    track_autoencoder.init_trajan_params(model, torch.Generator().manual_seed(0))
  model = model.to(device).eval()
  with torch.no_grad():
    out = model(inputs, generator=torch.Generator(device).manual_seed(0))

  err = np.abs(out.tracks[0].cpu().numpy() - tracks).mean()
  print(f"encoded {args.num_tracks} tracks x {args.num_frames} frames -> "
        f"latents; decoded tracks {tuple(out.tracks.shape)}, "
        f"mean reconstruction error {err:.4f} (normalized coords)")
  return out


if __name__ == "__main__":
  main()
