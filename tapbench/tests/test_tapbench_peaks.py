"""The yardstick's arithmetic against hand counts at small shapes."""

import math

import pytest
import torch

import peaks


def test_bound_takes_the_larger_side():
  assert peaks.bound_s(3.35e12, 0.0, "float32") == pytest.approx(1.0)
  assert peaks.bound_s(0.0, 165e12, "float32") == pytest.approx(1.0)
  assert peaks.bound_s(1.0, 989e12, "bfloat16") == pytest.approx(1.0)


def test_corr_touched_counts_the_union_of_windows():
  # One frame of a 10x10 grid, two queries whose 8x8 windows overlap by
  # 4 columns; a third whose window hangs 2 rows and 2 columns off.
  cy = torch.tensor([[5.2, 5.7, 1.0]])
  cx = torch.tensor([[3.5, 7.0, 1.4]])
  touched, inside = peaks.corr_touched(cy, cx, 10, 10, p=7)
  want = torch.zeros(10, 10, dtype=torch.bool)
  n_in = 0
  for y, x in ((5.2, 3.5), (5.7, 7.0), (1.0, 1.4)):
    for i in range(8):
      for j in range(8):
        r, c = math.floor(y) - 3 + i, math.floor(x) - 3 + j
        if 0 <= r < 10 and 0 <= c < 10:
          want[r, c] = True
          n_in += 1
  assert touched == int(want.sum())
  assert inside == n_in


def test_corr_bound_hand_count():
  # 100 touched positions of C = 4 float32, BT = 2 frames, N = 3 queries.
  nbytes = 100 * 4 * 4 + 2 * 3 * 4 * 4 + 2 * 2 * 3 * 4 + 2 * 49 * 3 * 4
  assert peaks.corr_bound_s(100, 50, 2, 3, 4, "float32") == pytest.approx(
      max(nbytes / 3.35e12, 2 * 50 * 4 / 165e12))


def test_mixer_bound_hand_count():
  b, t, c, h = 2, 3, 8, 32
  params = 2 * c + 2 * 3 * 4 * c + 2 * 4 * c + c * h + h + h * c + c
  nbytes = (2 * b * t * c + params) * 2
  flops = 4.0 * b * t * c * h
  assert peaks.mixer_bound_s(b, t, c, h, "bfloat16") == pytest.approx(
      max(nbytes / 3.35e12, flops / 989e12))
  # At the served shape, the products bound the float32 block: 0.813 ms.
  assert peaks.mixer_bound_s(128, 250, 512, 2048, "float32") == pytest.approx(
      4.0 * 128 * 250 * 512 * 2048 / 165e12)


def test_scan_bound_hand_count():
  assert peaks.scan_bound_s(5, 7, 3) == pytest.approx(
      (3 * 5 * 7 * 3 * 4 + 2 * 5 * 3 * 4) / 3.35e12)


def test_resnet_macs_hand_count():
  # One group of one block at 16x16: stem 7x7/2 to 8x8 (64 ch), then a
  # block with stride 1 and a projection.
  macs = peaks.resnet_macs((16, 16), [1], [32], strides=[1])
  stem = 8 * 8 * 49 * 3 * 64
  block = 8 * 8 * 9 * 64 * 32 + 8 * 8 * 9 * 32 * 32 + 8 * 8 * 64 * 32
  assert macs == stem + block


def test_tapnext_flops_hand_count():
  cfg = {"width": 8, "mlp_dim": 16, "num_heads": 2, "depth": 3,
         "patch_size": [1, 4, 4], "image_size": [8, 8]}
  tokens = 4 + 5
  d, m = 8, 16
  per = (3 * d * d + 2 * d * m + d * m + 2 * d * 4 + 4 * d * d + 2 * d * m
         + 2 * tokens * d)
  assert peaks.tapnext_flops(cfg, 7, 5) == 2.0 * 7 * tokens * 3 * per


def test_tapir_flops_counts_the_mixer_and_resolutions():
  cfg = {"initial_resolution": [16, 16], "lowres_dim": 8, "highres_dim": 4,
         "blocks_per_group": [1, 1, 1, 1], "extra_convs": False,
         "patch_size": 3, "pyramid_level": 0, "mixer_hidden_dim": 4,
         "num_mixer_blocks": 1, "mixer_kernel_size": 3, "num_pips_iter": 1}
  one = peaks.tapir_flops(cfg, 2, (16, 16), [[16, 16]], 5)
  two = peaks.tapir_flops(cfg, 2, (32, 32), [[32, 32]], 5)
  backbone16 = peaks.resnet_macs((16, 16), [1] * 4, (64, 4, 256, 8)) * 2
  backbone32 = peaks.resnet_macs((32, 32), [1] * 4, (64, 4, 256, 8)) * 2
  # The 16x16 backbone is shared by both resolutions of `one`.
  assert two - one == pytest.approx(2.0 * backbone32)
  c_in = 4 + 12 + 9 * 2
  mixer = c_in * 4 + (2 * 4 * 16 + 2 * 3 * 16) + 4 * 16
  corr = (4 + 8) * 16
  maps = 10
  stage1 = maps * 4 * (8 + 9 * 16 + 9 * 16) + maps * 1 * 9 * 16 * 32 + maps * (
      32 * 16 + 16 * 2)
  assert one == pytest.approx(2.0 * (backbone16 + stage1 + maps * (corr + mixer)))
