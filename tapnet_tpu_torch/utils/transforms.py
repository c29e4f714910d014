"""Coordinate-grid transforms (port of tapnet_tpu/utils/transforms.py).

Raster coordinates: (0, 0) is the corner of the upper-left pixel, so the
center of pixel (i, j) is at (j + 0.5, i + 0.5) in (x, y). Converting between
two grids that cover the same image is a pure scale.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

GridSize = Union[Sequence[int], np.ndarray]


def convert_grid_coordinates(
    coords: torch.Tensor,
    input_grid_size: GridSize,
    output_grid_size: GridSize,
    coordinate_format: str = "xy",
) -> torch.Tensor:
  """Rescales raster coordinates from one grid resolution to another.

  Args:
    coords: [..., 2] ("xy": (x, y)) or [..., 3] ("tyx": (t, y, x)).
    input_grid_size: (width, height) for "xy"; (frames, height, width) for
      "tyx".
    output_grid_size: same layout as `input_grid_size`.
    coordinate_format: "xy" or "tyx".

  Returns:
    float32 coordinates with the shape of `coords` (the scale factors are
    float32, as in the JAX version, so bf16 inputs come back float32).
  """
  in_size = np.asarray(input_grid_size)
  out_size = np.asarray(output_grid_size)

  if coordinate_format == "xy":
    if in_size.shape[0] != 2 or out_size.shape[0] != 2:
      raise ValueError("xy coordinates require length-2 grid sizes.")
  elif coordinate_format == "tyx":
    if in_size.shape[0] != 3 or out_size.shape[0] != 3:
      raise ValueError("tyx coordinates require length-3 grid sizes.")
    if in_size[0] != out_size[0]:
      raise ValueError("Converting frame count is not supported.")
  else:
    raise ValueError(f"Unknown coordinate format: {coordinate_format!r}")

  scale = torch.as_tensor(
      (out_size / in_size).astype(np.float32), device=coords.device
  )
  return coords * scale
