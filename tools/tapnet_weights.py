"""Seed-made TAP-Net weights and running statistics in the Flax layout
(numpy only).

No TAP-Net checkpoint is in the repository, so the port's TAP-Net checks
run on weights made here from a seed. `seeded_tapnet_params(config, seed)`
returns the (params, batch_stats) trees of `models.tapnet.TAPNet(config)`
(the JAX package's; `config` is either package's TapNetConfig): the
TSM-ResNet up to its unit_2 endpoint and the heads, which the JAX package
takes as they are (`model.apply({"params": params, "batch_stats": stats},
...)`) and the port through `checkpoints.convert.load_tapnet_params`.

Scales follow the Flax initializers (LeCun truncated normals over each
kernel's fan-in: kh * kw * C_in for a convolution, the input width for a
Dense; the heads' kernels are (1, 3, 3, C_in, C_out)). Where Flax starts at
zero or one (biases, BatchNorm scales), the values here are small
perturbations of it (0.02 deviations), so that every parameter takes part
in a check. The running statistics are not Flax's zeros and ones either:
means drawn with deviation 0.1 and variances uniform in [0.5, 2], so that
the eval forward's normalization differs from the training one's and from
the identity.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from tools.tapnext_weights import _Maker

_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
           101: (3, 4, 23, 3), 152: (3, 8, 36, 3), 200: (3, 24, 36, 3)}
_UNITS = 3  # TAP-Net's endpoint is unit_2.


def _norm(m: _Maker, stats: Dict[str, Any], name: str, width: int):
  stats[name] = {"mean": m.normal((width,), 0.1),
                 "var": m.rng.uniform(0.5, 2.0, (width,)).astype(np.float32)}
  return {"scale": m.near((width,), 1.0), "bias": m.near((width,), 0.0)}


def _conv(m: _Maker, k: int, cin: int, cout: int):
  return {"kernel": m.truncated((k, k, cin, cout), 1.0, k * k * cin)}


def seeded_tapnet_params(config, seed: int = 0
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """(params, batch_stats) of TAPNet(config), made from `seed`."""
  m = _Maker(seed)
  bottleneck = config.depth >= 50
  params = {"stem_conv": _conv(m, 7, 3, 64)}
  stats: Dict[str, Any] = {}
  in_c = 64
  for unit in range(_UNITS):
    channels = 256 * 2**unit
    out_c = channels if bottleneck else channels // 4
    mid_c = channels // 4
    for block in range(_BLOCKS[config.depth][unit]):
      name = f"unit_{unit}_block_{block}"
      p, s = {}, {}
      p["norm_pre"] = _norm(m, s, "norm_pre", in_c)
      if block == 0:
        p["proj_conv"] = _conv(m, 1, in_c, out_c)
      if bottleneck:
        p["conv_0"] = _conv(m, 1, in_c, mid_c)
        p["norm_0"] = _norm(m, s, "norm_0", mid_c)
        p["conv_1"] = _conv(m, 3, mid_c, mid_c)
      else:
        p["conv_0"] = _conv(m, 3, in_c, mid_c)
      p["norm_1"] = _norm(m, s, "norm_1", mid_c)
      p["conv_2"] = _conv(m, 1 if bottleneck else 3, mid_c, out_c)
      params[name], stats[name] = p, s
      in_c = out_c
  heads = config.num_heads
  head_conv = lambda cin, cout: {
      "kernel": m.truncated((1, 3, 3, cin, cout), 1.0, 9 * cin),
      "bias": m.near((cout,), 0.0)}
  return ({"backbone": params,
           "heads": {"pos_conv": head_conv(heads, 16),
                     "pos_out": head_conv(16, 1),
                     "occ_conv": head_conv(16, 32),
                     "occ_dense": m.dense(32, 16),
                     "occ_out": m.dense(16, 1)}},
          {"backbone": stats})
