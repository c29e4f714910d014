"""Losses shared by the training tasks (port of tapnet_tpu/utils/losses.py).

The TAP loss of TAPIR training: a Huber loss on the positions of visible
points, a BCE on the model's estimate of being within a threshold of the
target (expected_dist), and an occlusion BCE; points are rescaled to 256x256
before the loss.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.utils import transforms


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
  """Numerically stable sigmoid BCE, elementwise: -labels * log_sigmoid(x)
  - (1 - labels) * log_sigmoid(-x)."""
  log_p = F.logsigmoid(logits)
  log_not_p = F.logsigmoid(-logits)
  return -labels * log_p - (1.0 - labels) * log_not_p


def _mean(loss: torch.Tensor, reduction_axes) -> torch.Tensor:
  return loss.mean(dim=tuple(reduction_axes)) if reduction_axes else loss


def huber_loss(tracks: torch.Tensor, target_points: torch.Tensor,
               occluded: torch.Tensor, delta: float = 4.0,
               reduction_axes: Optional[Sequence[int]] = (1, 2)
               ) -> torch.Tensor:
  """Huber loss on point trajectories, masked to visible points."""
  distsqr = (tracks - target_points).square().sum(-1)
  dist = torch.sqrt(distsqr + 1e-12)
  loss = torch.where(dist < delta, distsqr / 2, delta * (dist - delta / 2))
  return _mean(loss * (1.0 - occluded), reduction_axes)


def prob_loss(tracks: torch.Tensor, expd: torch.Tensor,
              target_points: torch.Tensor, occluded: torch.Tensor,
              expected_dist_thresh: float = 8.0,
              reduction_axes: Optional[Sequence[int]] = (1, 2)
              ) -> torch.Tensor:
  """BCE on the model's estimate of lying within `expected_dist_thresh` of
  the target."""
  err = (tracks - target_points).square().sum(-1)
  invalid = (err > expected_dist_thresh**2).to(expd.dtype)
  loss = sigmoid_binary_cross_entropy(expd, invalid)
  return _mean(loss * (1.0 - occluded), reduction_axes)


def tapnet_loss(
    points: torch.Tensor,
    occlusion: torch.Tensor,
    target_points: torch.Tensor,
    target_occ: torch.Tensor,
    shape: Sequence[int],
    mask: Optional[torch.Tensor] = None,
    expected_dist: Optional[torch.Tensor] = None,
    position_loss_weight: float = 0.05,
    expected_dist_thresh: float = 6.0,
    huber_loss_delta: float = 4.0,
    rebalance_factor: Optional[float] = None,
    occlusion_loss_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Combined TAP loss: Huber position + occlusion BCE + uncertainty BCE.

  Args:
    points: [B, N, T, 2] predicted (x, y) raster points.
    occlusion: [B, N, T] occlusion logits.
    target_points: same layout as points.
    target_occ: [B, N, T] binary occlusion targets.
    shape: [B, T, H, W, C] of the source video.
    mask: optional [B, N, T] inclusion mask.
    expected_dist: optional [B, N, T] uncertainty logits.
    position_loss_weight: weight of the position term.
    expected_dist_thresh: pixel threshold of the uncertainty target.
    huber_loss_delta: quadratic-to-linear crossover.
    rebalance_factor: visible points weighted (1 + factor) in the occlusion
      BCE.
    occlusion_loss_mask: optional extra [B, N, T] mask on the occlusion
      term.

  Returns:
    (loss_huber, loss_occ, loss_prob) scalars.
  """
  if mask is None:
    mask = 1.0
  wh = tuple(shape)[3:1:-1]
  points = transforms.convert_grid_coordinates(points, wh, (256, 256))
  target_points = transforms.convert_grid_coordinates(target_points, wh,
                                                      (256, 256))
  loss_huber = huber_loss(points, target_points, target_occ,
                          delta=huber_loss_delta, reduction_axes=None) * mask
  loss_huber = loss_huber.mean() * position_loss_weight

  if expected_dist is None:
    loss_prob = torch.zeros((), device=points.device)
  else:
    loss_prob = prob_loss(points.detach(), expected_dist, target_points,
                          target_occ, expected_dist_thresh,
                          reduction_axes=None) * mask
    loss_prob = loss_prob.mean()

  target_occ = target_occ.to(occlusion.dtype)
  loss_occ = sigmoid_binary_cross_entropy(occlusion, target_occ) * mask
  if rebalance_factor is not None:
    loss_occ = loss_occ * ((1 + rebalance_factor)
                           - rebalance_factor * target_occ)
  if occlusion_loss_mask is not None:
    loss_occ = loss_occ * occlusion_loss_mask
  return loss_huber, loss_occ.mean(), loss_prob
