"""Full-precision convolution with Flax "SAME" padding.

Port of tapnet_tpu/ops/qconv.py::conv2d_fp_math. The JAX version is XLA's
convolution, not a Pallas kernel, so this stays `F.conv2d`. Layouts are
PyTorch's (NCHW activations, OIHW weights).

Flax "SAME" pads asymmetrically when the stride does not divide the input:
for a 3x3 stride-2 conv on an even input it pads 0 before and 1 after; for
the 7x7 stride-2 stem, 2 and 3. `F.conv2d(padding=...)` is symmetric, so
such cases take an explicit `F.pad`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(before, after) padding of one axis under XLA's SAME rule."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def conv2d_fp_math(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
  """SAME conv (+ bias), IO and weights in x.dtype.

  Args:
    x: [N, C_in, H, W].
    weight: [C_out, C_in, kh, kw].
    bias: optional [C_out].
    stride: spatial stride.
  """
  kh, kw = weight.shape[2:]
  top, bottom = same_padding(x.shape[2], kh, stride)
  left, right = same_padding(x.shape[3], kw, stride)
  weight = weight.to(x.dtype)
  bias = None if bias is None else bias.to(x.dtype)
  if top == bottom and left == right:
    return F.conv2d(x, weight, bias, stride=stride, padding=(top, left))
  x = F.pad(x, (left, right, top, bottom))
  return F.conv2d(x, weight, bias, stride=stride)
