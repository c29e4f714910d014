"""Losses shared by the training tasks (port of tapnet_tpu/utils/losses.py:
`sigmoid_binary_cross_entropy`; the TAPIR losses come with TAPIR
training)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
  """Numerically stable sigmoid BCE, elementwise: -labels * log_sigmoid(x)
  - (1 - labels) * log_sigmoid(-x)."""
  log_p = F.logsigmoid(logits)
  log_not_p = F.logsigmoid(-logits)
  return -labels * log_p - (1.0 - labels) * log_not_p
