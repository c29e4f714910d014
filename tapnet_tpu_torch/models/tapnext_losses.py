"""TAPNext training losses (port of tapnet_tpu/models/tapnext_losses.py).

The Huber coordinate loss, the masked-L1 patch reconstruction, the per-axis
quantized-coordinate cross-entropy and the certainty BCE, as plain functions
returning per-element values, and `tapnext_loss`, the combined loss with
per-layer deep supervision averaged over the intermediate heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tapnet_tpu_torch.utils.losses import sigmoid_binary_cross_entropy


def huber(pred_points: torch.Tensor, target_points: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
  """Huber on (y, x) points; targets clipped to the 256 raster. Returns
  [..., 1] per-point values."""
  pred_points = pred_points.float()
  target_points = torch.clamp(target_points.float(), 0, 255)
  error = torch.clamp(pred_points - target_points, -1e8, 1e8)
  distsqr = torch.sum(torch.square(error), dim=-1, keepdim=True)
  dist = torch.sqrt(distsqr + 1e-12)
  return torch.where(dist < delta, distsqr / 2, delta * (dist - delta / 2))


def masked_l1_patches(pred_patches: torch.Tensor,
                      target_patches: torch.Tensor,
                      image_norm: str = "sum") -> torch.Tensor:
  """L1 patch-reconstruction loss over [..., T, h, w, C] patches."""
  loss = torch.abs(pred_patches.float() - target_patches.float())
  if image_norm == "sum":
    loss = torch.sum(loss, dim=(-1, -2, -3)) / 1024.0
  elif image_norm == "mean":
    loss = torch.mean(loss, dim=(-1, -2, -3))
  else:
    raise ValueError(f"Unknown image_norm {image_norm!r}")
  return torch.mean(loss, dim=-1)[..., None]


def coordinate_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                             pixel_size: int = 256) -> torch.Tensor:
  """Per-axis softmax CE on quantized coordinates: logits [..., 2 *
  pixel_size] (first half axis 0), labels [..., 2] continuous raster
  coordinates, rounded half to even after the -0.5 shift. Returns [..., 1],
  the two axes' CE summed."""
  logits = logits.float()
  labels = torch.round(torch.clamp(labels.float() - 0.5, 0, pixel_size - 1))
  labels = labels.long()
  logits_0, logits_1 = torch.split(logits, logits.shape[-1] // 2, dim=-1)

  def ce(lg, lab):
    logp = torch.log_softmax(lg, dim=-1)
    return -torch.gather(logp, -1, lab[..., None])

  return ce(logits_0, labels[..., 0]) + ce(logits_1, labels[..., 1])


def certainty(logits: torch.Tensor, pred_points: torch.Tensor,
              target_points: torch.Tensor,
              threshold: float = 1.0) -> torch.Tensor:
  """BCE on "was my prediction within threshold" (TAPIR eq. 1, term 3); no
  gradient flows into the prediction."""
  pred = pred_points.float().detach()
  distsqr = torch.sum(torch.square(pred - target_points.float()), dim=-1,
                      keepdim=True)
  is_certain = (distsqr <= threshold**2).float()
  return sigmoid_binary_cross_entropy(logits.float(), is_certain)


def tapnext_loss(
    results,
    target_points: torch.Tensor,  # [B, Q, T, 2] (y, x) raster
    visible: torch.Tensor,  # [B, Q, T] 1 = visible
    loss_mask: Optional[torch.Tensor] = None,  # [B, Q, T]
    huber_delta: float = 1.0,
    intermediate_weight: float = 1.0,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """Combined TAPNext loss with per-layer deep supervision: position terms
  masked to visible points, the visibility BCE everywhere (within
  loss_mask).

  With a `mesh` (`parallel.mesh.Mesh`) the inputs are this rank's share of
  the (batch, query) elements and the loss is the rank's share of the global
  loss: the masks' counts are summed over every rank and each term is scaled
  by the rank count, so that the mean over ranks is the loss of the whole
  batch (the normalisers depend on the data, so a mean of local means would
  not be)."""
  if loss_mask is None:
    loss_mask = torch.ones(visible.shape, dtype=torch.float32,
                           device=visible.device)
  vis_mask = (loss_mask * visible)[..., None]
  any_mask = loss_mask[..., None]
  ranks = 1 if mesh is None else mesh.size()

  def count(mask):
    total = mask.sum() if mesh is None else mesh.all_sum(mask.sum())
    return torch.clamp(total, min=1.0) / ranks

  vis_count, any_count = count(vis_mask), count(any_mask)

  def terms(tracks, track_logits, visible_logits):
    l_coord = coordinate_cross_entropy(track_logits, target_points)
    l_huber = huber(tracks, target_points, delta=huber_delta)
    l_vis = sigmoid_binary_cross_entropy(visible_logits.float(),
                                         visible[..., None])
    coord = torch.sum(l_coord * vis_mask) / vis_count
    hub = torch.sum(l_huber * vis_mask) / vis_count
    vis = torch.sum(l_vis * any_mask) / any_count
    return coord, hub, vis

  coord, hub, vis = terms(results.tracks, results.track_logits,
                          results.visible_logits)
  loss = coord + hub + vis
  scalars = {"coordinate_loss": coord, "huber_loss": hub,
             "visible_loss": vis}
  inter = list(zip(results.intermediate_tracks,
                   results.intermediate_track_logits,
                   results.intermediate_visible_logits))
  for i, (tr, lg, vl) in enumerate(inter):
    c, h, v = terms(tr, lg, vl)
    loss = loss + intermediate_weight * (c + h + v) / max(len(inter), 1)
    scalars[f"intermediate_loss_{i}"] = c + h + v
  scalars["loss"] = loss
  return loss, scalars
