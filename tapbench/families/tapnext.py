"""The TAPNext family: `TapnextPredictor` (offline, time chunks) and
`OnlineTapnextPredictor` (a batch of streams) from the port, their model
FLOPs and scan bounds, and their comparison with the plain reference.

No TAPNext checkpoint is released in the repository, so the weights are made
here from the seed, on the device, in two draws (one normal, one uniform)
carved into the Flax tree, with the scales of the JAX modules' initialisers
(as `tools/tapnext_weights.py` sets them): LeCun truncated normals for dense,
patch and block-diagonal kernels, Xavier-uniform for the ViT blocks, 2/depth
fan-in variance for each SSM block's two output projections, 0.01 for the
temporal conv, Griffin's `a_param`, normal(1/sqrt(width)) tokens and position
embeddings, and biases and norm scales 0.02 deviations from Flax's zeros and
ones, so that every parameter takes part. The predictors take the tree with
numpy leaves, so it passes once through the host.

The control is the reference put in the program's place with the ViT
blocks' products in float8 e4m3 (`reference.tapnext_ref`), the step below
the configuration's bfloat16.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

import judge
import peaks
from reference import tapnext_ref

_TRUNC_STD = 0.87962566103423978  # a unit normal truncated at +-2
_SMALL = 0.02


class _Spec:
  """The tree's leaves in the order they are drawn: (path, shape, kind,
  args)."""

  def __init__(self):
    self.leaves: List[Tuple[Tuple[str, ...], Tuple[int, ...], str, tuple]] = []

  def add(self, path, shape, kind, *args):
    self.leaves.append((tuple(path), tuple(shape), kind, args))

  def dense(self, path, fan_in, fan_out, variance=1.0):
    self.add(path + ("kernel",), (fan_in, fan_out), "trunc", variance, fan_in)
    self.add(path + ("bias",), (fan_out,), "near", 0.0)

  def layer_norm(self, path, width):
    self.add(path + ("scale",), (width,), "near", 1.0)
    self.add(path + ("bias",), (width,), "near", 0.0)


def _spec(m: Dict) -> _Spec:
  s = _Spec()
  c, mlp, heads, depth = m["width"], m["mlp_dim"], m["num_heads"], m["depth"]
  _, ph, pw = m["patch_size"]
  h, w = m["image_size"]
  bw, hd = c // heads, c // heads
  for lyr in range(depth):
    ssm = ("backbone", "Transformer", f"encoderblock_{lyr}", "ssm_block")
    s.add(ssm + ("temporal_pre_norm", "scale"), (c,), "near", 0.0)
    rb = ssm + ("recurrent_block",)
    s.dense(rb + ("linear_y",), c, c)
    s.dense(rb + ("linear_x",), c, c)
    s.add(rb + ("conv_1d", "w"), (4, c), "trunc", 0.01, 4)
    s.add(rb + ("conv_1d", "b"), (c,), "near", 0.0)
    s.add(rb + ("rg_lru", "a_param"), (c,), "a_param")
    for gate in ("input_gate", "a_gate"):
      s.add(rb + ("rg_lru", gate, "w"), (heads, bw, bw), "trunc", 1.0, bw)
      s.add(rb + ("rg_lru", gate, "b"), (heads, bw), "near", 0.0)
    s.dense(rb + ("linear_out",), c, c, 2.0 / depth)
    s.add(ssm + ("channel_pre_norm", "scale"), (c,), "near", 0.0)
    s.add(ssm + ("mlp_block", "ffw_up", "w"), (2, c, mlp), "trunc", 1.0, c)
    s.add(ssm + ("mlp_block", "ffw_up", "b"), (2, 1, 1, mlp), "near", 0.0)
    s.dense(ssm + ("mlp_block", "ffw_down"), mlp, c, 2.0 / depth)
    vit = ("backbone", "Transformer", f"encoderblock_{lyr}", "vit_block")
    s.layer_norm(vit + ("LayerNorm_0",), c)
    att = vit + ("MultiHeadDotProductAttention_0",)
    for name in ("query", "key", "value"):
      s.add(att + (name, "kernel"), (c, heads, hd), "xavier", c, c)
      s.add(att + (name, "bias"), (heads, hd), "near", 0.0)
    s.add(att + ("out", "kernel"), (heads, hd, c), "xavier", c, c)
    s.add(att + ("out", "bias"), (c,), "near", 0.0)
    s.layer_norm(vit + ("LayerNorm_1",), c)
    s.add(vit + ("MlpBlock_0", "Dense_0", "kernel"), (c, mlp), "xavier", c, mlp)
    s.add(vit + ("MlpBlock_0", "Dense_0", "bias"), (mlp,), "normal", 1e-6)
    s.add(vit + ("MlpBlock_0", "Dense_1", "kernel"), (mlp, c), "xavier", mlp, c)
    s.add(vit + ("MlpBlock_0", "Dense_1", "bias"), (c,), "normal", 1e-6)
  s.layer_norm(("backbone", "Transformer", "encoder_norm"), c)
  s.add(("backbone", "embedding", "kernel"), (1, ph, pw, 3, c), "trunc", 1.0,
        ph * pw * 3)
  s.add(("backbone", "embedding", "bias"), (c,), "near", 0.0)
  std = 1.0 / math.sqrt(c)
  s.add(("backbone", "mask_token"), (1, 1, 1, c), "normal", std)
  s.add(("backbone", "unknown_token"), (1, 1, c), "normal", std)
  s.add(("backbone", "point_query_token"), (1, 1, 1, c), "normal", std)
  s.add(("backbone", "pos_embedding"), (1, (h // ph) * (w // pw), c), "normal",
        std)
  s.add(("backbone", "pos_embedding_full"), (1, h * w, c), "normal", std)
  for head, out in (("visible_head", 1), ("coordinate_head", 512)):
    s.dense((head, "layers_0"), c, 256)
    s.layer_norm((head, "layers_1"), 256)
    s.dense((head, "layers_3"), 256, 256)
    s.layer_norm((head, "layers_4"), 256)
    s.dense((head, "layers_6"), 256, out)
  return s


def seeded_params(m: Dict, seed: int, device) -> Dict:
  """The TAPNext Flax tree for the "model" fields `m`, made from `seed` on
  `device` (one normal and one uniform draw), as numpy leaves."""
  spec = _spec(m)
  size = lambda shape: int(np.prod(shape))
  uniform_kinds = ("xavier", "a_param")
  n_norm = sum(size(s) for _, s, k, _ in spec.leaves if k not in uniform_kinds)
  n_unif = sum(size(s) for _, s, k, _ in spec.leaves if k in uniform_kinds)
  gen = torch.Generator(device=device).manual_seed(seed)
  normal = torch.randn(n_norm, generator=gen, device=device)
  unif = torch.rand(n_unif, generator=gen, device=device)
  parts, i, j = [], 0, 0
  for _, shape, kind, args in spec.leaves:
    k = size(shape)
    if kind in uniform_kinds:
      u = unif[j:j + k]
      j += k
      if kind == "xavier":
        limit = math.sqrt(6.0 / (args[0] + args[1]))
        parts.append(u * (2 * limit) - limit)
      else:  # Griffin: a in [0.9, 0.999], softplus(a_param) = -log(a) / 8
        a = u * (0.999 - 0.9) + 0.9
        parts.append(torch.log(torch.expm1(-torch.log(a) / 8.0)))
      continue
    z = normal[i:i + k]
    i += k
    if kind == "trunc":
      variance, fan_in = args
      parts.append(z.clamp(-2.0, 2.0) * (math.sqrt(variance / fan_in)
                                         / _TRUNC_STD))
    elif kind == "near":
      parts.append(z * _SMALL + args[0])
    else:
      parts.append(z * args[0])
  flat = torch.cat(parts).cpu().numpy()
  tree: Dict = {}
  at = 0
  for path, shape, _, _ in spec.leaves:
    k = size(shape)
    node = tree
    for p in path[:-1]:
      node = node.setdefault(p, {})
    node[path[-1]] = flat[at:at + k].reshape(shape)
    at += k
  return tree


def _port_config(m: Dict):
  from tapnet_tpu_torch.models import ssm_vit  # pylint: disable=import-outside-toplevel
  keys = ("width", "depth", "mlp_dim", "num_heads", "patch_size", "image_size",
          "compute_dtype")
  return ssm_vit.SsmVitConfig(**{k: tuple(m[k]) if isinstance(m[k], list)
                                 else m[k] for k in keys})


class System:
  """The system under test of one run: `TapnextPredictor` (offline) or
  `OnlineTapnextPredictor` (online) on the cell's options, or with
  `control` the reference with float8 ViT products in their place."""

  def __init__(self, config: Dict, cell: Dict, seed: int, device,
               control: bool = False):
    from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
    self.config, self.cell, self.device = config, cell, device
    self.model_cfg = config["model"]
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]["matmul"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]["cudnn"]
    self.params = seeded_params(self.model_cfg, seed, device)
    self.chunk = cell["program"].get("chunk_size")
    self.control = None
    self.online = cell["loop"] == "online"
    if control:
      self.control = tapnext_ref.build(self.model_cfg, self.params, device)
      self.control.vit_fp8 = True
    elif self.online:
      self.predictor = inference.OnlineTapnextPredictor(
          self.params, _port_config(self.model_cfg), device=device)
    else:
      self.predictor = inference.TapnextPredictor(
          self.params, _port_config(self.model_cfg), chunk_size=self.chunk,
          device=device)
    self._state = None

  # Offline: one answer per (video, query points).
  def serve(self, requests: Iterable) -> Iterator[Dict]:
    for video, qp in requests:
      if self.control is not None:
        tracks, occ = tapnext_ref.track(self.control, video, qp,
                                        self.chunk or video.shape[1], "fp8")
        yield {"tracks": tracks.cpu().numpy(), "occlusion": occ.cpu().numpy()}
      else:
        yield self.predictor(video, qp)

  # Online: a batch of streams, one frame a step.
  @torch.no_grad()
  def init(self, frames: torch.Tensor, qp: torch.Tensor):
    """frames [S, 1, H, W, 3], queries [S, Q, 3] -> (x, y) tracks [S, Q, 2]
    and occlusion logits [S, Q] of the first frame."""
    if self.control is not None:
      self._qp, self._step = qp, 1
      tr, vis, self._state = self.control.forward_chunk(frames.float(), qp, 0,
                                                        None)
      return tr[:, :, 0].flip(-1).cpu().numpy(), (-vis[:, :, 0]).cpu().numpy()
    tracks, vis = self.predictor.init(frames, qp)
    return tracks[:, :, 0, ::-1], -vis[:, :, 0, 0]

  @torch.no_grad()
  def step(self, frame: torch.Tensor):
    """frame [S, H, W, 3] -> (x, y) tracks [S, Q, 2], occlusion logits
    [S, Q], on the host."""
    if self.control is not None:
      tr, vis, self._state = self.control.forward_chunk(
          frame[:, None].float(), self._qp, self._step, self._state)
      self._step += 1
      return tr[:, :, 0].flip(-1).cpu().numpy(), (-vis[:, :, 0]).cpu().numpy()
    tracks, vis = self.predictor.step(frame)
    return tracks[..., ::-1], -vis

  def release(self) -> None:
    self.predictor = self.control = self._state = None

  # ------------------------------------------------------------ yardstick

  def request_flops(self, traffic: Dict) -> float:
    """One request offline; one step of every stream online."""
    if self.online:
      return traffic["pool"] * peaks.tapnext_flops(self.model_cfg, 1,
                                                   traffic["queries"])
    return peaks.tapnext_flops(self.model_cfg, traffic["frames"],
                               traffic["queries"])

  def bounds(self, outputs: List, traffic: Dict) -> Dict[str, float]:
    """Least seconds of the linear scans of these requests: one a layer and
    time chunk, over [(tokens + queries), chunk, width] in float32. A
    one-frame step launches none."""
    if self.online:
      return {}
    m = self.model_cfg
    _, ph, pw = m["patch_size"]
    rows = (m["image_size"][0] // ph) * (m["image_size"][1] // pw) + traffic["queries"]
    t = traffic["frames"]
    chunk = self.chunk or t
    per = sum(peaks.scan_bound_s(rows, min(chunk, t - s), m["width"])
              for s in range(0, t, chunk))
    return {"scan": per * m["depth"] * len(outputs)}

  # ------------------------------------------------------------ correctness

  def compare(self, window, traffic, seed: int) -> Dict[str, float]:
    """The reference over, offline, a sample of the window's requests drawn
    from the seed; online, every stream over every frame from `init` to the
    window's last step."""
    check = self.cell["check"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = tapnext_ref.build(self.model_cfg, self.params, self.device)
    gaps = []
    if self.online:
      frames, qp = traffic.streams()
      steps = len(window.outputs)
      idx = torch.arange(steps, device=frames.device) % frames.shape[1]
      tracks, occ = tapnext_ref.track(model, frames[:, idx], qp,
                                      check["frame_chunk"])
      got = {"tracks": np.stack([o[0] for o in window.outputs], 2),
             "occlusion": np.stack([o[1] for o in window.outputs], 2)}
      gaps.append(judge.gap(got, {"tracks": tracks.cpu().numpy(),
                                  "occlusion": occ.cpu().numpy()}))
    else:
      done = window.outputs
      rng = random.Random(seed)
      for i in sorted(rng.sample(range(len(done)), min(check["requests"],
                                                       len(done)))):
        video, qp = traffic.request(window.request_ids[i])
        tracks, occ = tapnext_ref.track(model, video, qp, check["frame_chunk"])
        gaps.append(judge.gap(done[i], {"tracks": tracks.cpu().numpy(),
                                        "occlusion": occ.cpu().numpy()}))
    del model
    return judge.summarize(gaps, check["block_frames"])
