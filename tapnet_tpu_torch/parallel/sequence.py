"""Sequence-parallel linear recurrence and causal conv over ranks (port of
tapnet_tpu/parallel/sequence.py).

The time axis of a [B, T, C] sequence is split in P equal parts, one per
rank along a mesh axis (`shard_time`), and each function takes and returns
this rank's part. For the RG-LRU recurrence y[t] = a[t] * y[t-1] + x[t]:

  1. every rank runs the local scan (`ops.scan.linear_scan`: K5 on the
     card) on its part from a zero carry, and a second K5 launch gives the
     in-part cumulative decay prod(a[0..t]) (a scan whose only input is
     a[0] at t = 0);
  2. the ranks' (total_decay, last_state) pairs, two [B, C] tensors, are
     all-gathered;
  3. each rank runs the P-step carry scan over them, and corrects its
     outputs in one multiply-add: y += cumdecay * carry_in.

Communication is O(P * B * C), independent of T. Both functions carry
gradients: the local scans through K5b (the scan's VJP), the gathers
through `Mesh.all_gather`, whose backward sums the ranks' cotangents. Each
builds the same autograd graph on every rank (a rank's own part is indexed
out, never chosen by a branch), so that the ranks' backward passes run their
collectives in one order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tapnet_tpu_torch.ops import scan as scan_lib
from tapnet_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, shard


def shard_time(x: torch.Tensor, mesh: Mesh,
               time_axis: str = DATA_AXIS) -> torch.Tensor:
  """This rank's part of [B, T, ...] along T; raises if the mesh axis does
  not divide T."""
  return shard(x, mesh, time_axis, dim=1)


def _local_pass(x: torch.Tensor, a: torch.Tensor):
  """Local scan from a zero carry and the in-part cumulative decay: two
  launches of the scan. Returns (y_local [B, T, C] in x's dtype, last_local
  [B, C] float32, cumdecay [B, T, C] in a's dtype, total_decay [B, C]
  float32)."""
  zeros = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                      device=x.device)
  y_local, last_local = scan_lib.linear_scan(x.contiguous(), a.contiguous(),
                                             zeros)
  seed = torch.cat([a[:, :1], torch.zeros_like(a[:, 1:])], dim=1)
  cumdecay, total_decay = scan_lib.linear_scan(seed, a.contiguous(), zeros)
  return y_local, last_local, cumdecay, total_decay


def sequence_parallel_linear_scan(
    x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor], mesh: Mesh,
    time_axis: str = DATA_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
  """h[t] = a[t] * h[t-1] + x[t] with T split over `time_axis`.

  Args:
    x: [B, T / P, C] this rank's part of the inputs (`shard_time`).
    a: [B, T / P, C] its part of the decays.
    h0: [B, C] float32 initial state (None: zeros), the same on every rank.
    mesh / time_axis: the mesh and the axis T is split over.

  Returns:
    (y [B, T / P, C] this rank's part, h_last [B, C] float32 on every rank).
  """
  if h0 is None:
    h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                     device=x.device)
  y_local, last_local, cumdecay, total_decay = _local_pass(x, a)
  # [P, 2, B, C]: every rank's (total_decay, last_state), in time order.
  pairs = mesh.all_gather(torch.stack([total_decay, last_local]), time_axis)
  carries = [h0]
  for p in range(pairs.shape[0]):
    carries.append(pairs[p, 0] * carries[-1] + pairs[p, 1])
  # Indexed out of one stack, so that every rank builds the same graph (the
  # backward's collectives run in an order that depends on it).
  carry_in = torch.stack(carries[:-1])[mesh.index(time_axis)]
  y = y_local.float() + cumdecay.float() * carry_in[:, None, :]
  return y.to(x.dtype), carries[-1]


def sequence_parallel_causal_conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    cache: Optional[torch.Tensor], mesh: Mesh,
    time_axis: str = DATA_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
  """Depthwise causal temporal conv with T split over `time_axis`.

  The numerics of `models.rglru.CausalConv1D`: zero history for a fresh
  sequence (cache None), else `cache` [B, k-1, C] holds the last k-1 frames
  of the previous chunk. The ranks all-gather their min(k-1, T/P)-frame
  tails (O(P * B * k * C), independent of T); each takes its exact k-1
  frames of history from [cache ++ tails], which holds the whole global
  prefix when a part has fewer than k-1 frames, and runs the same k shifted
  multiply-adds locally. The streaming cache comes from the same buffer.

  Args:
    x: [B, T / P, C] this rank's part.
    w: [k, C] depthwise kernel; b: [C] bias.
    cache: optional [B, k-1, C] history, the same on every rank.

  Returns:
    (y [B, T / P, C] this rank's part, new_cache [B, k-1, C] on every rank).
  """
  k = w.shape[0]
  bsz, t_local, c = x.shape
  p = mesh.size(time_axis)
  if cache is None:
    cache = x.new_zeros((bsz, k - 1, c))
  m = min(k - 1, t_local)
  # [P, B, m, C] -> [B, P * m, C]: every part's tail, in time order.
  tails = mesh.all_gather(x[:, t_local - m:], time_axis)
  tails = tails.permute(1, 0, 2, 3).reshape(bsz, p * m, c)
  hist = torch.cat([cache.to(x.dtype), tails], dim=1)
  # Part i's k-1 frames of history are rows [i*m, i*m + k-1) of
  # [cache ++ tails]: for i = 0 the cache itself; else the slice ends at the
  # last gathered frame before this part.
  start = mesh.index(time_axis) * m
  full = torch.cat([hist[:, start:start + k - 1], x], dim=1)
  y = torch.zeros_like(x) + b
  for j in range(k):
    y = y + full[:, j:j + t_local] * w[j]
  # The last k-1 global frames (cache rows too, if T < k-1).
  return y, hist[:, hist.shape[1] - (k - 1):]
