"""The TAPIR family: `TapirPredictor.track_many` from the port, its model
FLOPs and kernel bounds, and its comparison with the plain reference.

The weights are the configuration's checkpoint file, loaded here with numpy
and handed, as the same tree, to the program (which converts it itself) and
to the reference (which converts it itself).

The control is the program's own bfloat16 path (`bfloat16=True`): the step
below the configuration's float32.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Iterable, Iterator, List

import numpy as np
import torch

import judge
import peaks
from reference import tapir_ref

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def load_params(path: str) -> Dict:
  """The checkpoint's Flax tree, float16 leaves made float32."""
  tree = np.load(os.path.join(REPO, path), allow_pickle=True).item()
  tree = tree.get("params", tree)

  def up(v):
    if isinstance(v, dict):
      return {k: up(x) for k, x in v.items()}
    arr = np.asarray(v)
    return arr.astype(np.float32) if arr.dtype == np.float16 else arr

  return up(tree)


def set_precision(tf32: Dict) -> None:
  torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
  torch.backends.cudnn.allow_tf32 = tf32["cudnn"]


class System:
  """The system under test of one run: a `TapirPredictor` on the cell's
  options, or with `control` its bfloat16 path."""

  def __init__(self, config: Dict, cell: Dict, seed: int, device,
               control: bool = False):
    from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
    from tapnet_tpu_torch.models import tapir  # pylint: disable=import-outside-toplevel
    del seed  # the weights are the checkpoint's
    self.config, self.cell, self.device = config, cell, device
    self.model_cfg = config["model"]
    self.params = load_params(config["weights"]["file"])
    set_precision(config["tf32"])
    fields = {f.name for f in dataclasses.fields(tapir.TapirConfig)}
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in self.model_cfg.items() if k in fields}
    opts = cell["program"]
    self.predictor = inference.TapirPredictor(
        self.params, tapir.TapirConfig(**kwargs), bfloat16=control,
        query_chunk_size=opts["query_chunk_size"],
        refinement_resolutions=opts["refinement_resolutions"], device=device)

  def serve(self, requests: Iterable) -> Iterator[Dict]:
    return self.predictor.track_many(requests)

  def release(self) -> None:
    del self.predictor

  # ------------------------------------------------------------ yardstick

  def request_flops(self, traffic: Dict) -> float:
    return peaks.tapir_flops(
        self.model_cfg, traffic["frames"], (traffic["height"], traffic["width"]),
        self.cell["program"]["refinement_resolutions"], traffic["queries"])

  def bounds(self, outputs: List[Dict], traffic: Dict) -> Dict[str, float]:
    """Least seconds of the corr-tents and mixer-block calls of these
    requests. A corr-tents call's window centres are taken from the
    request's final tracks: the refinement moves a track by little after
    stage 1, and the bound counts the grid positions the windows touch."""
    m = self.model_cfg
    dtype = m["compute_dtype"]
    t, n = traffic["frames"], traffic["queries"]
    h, w = traffic["height"], traffic["width"]
    chunk = self.cell["program"]["query_chunk_size"]
    res = self.cell["program"]["refinement_resolutions"]
    iters = m["num_pips_iter"]
    chunks = [min(chunk, n - s) for s in range(0, n, chunk)]
    mixer = sum(peaks.mixer_bound_s(c, t, m["mixer_hidden_dim"],
                                    4 * m["mixer_hidden_dim"], dtype)
                for c in chunks) * m["num_mixer_blocks"] * iters * len(res)
    corr = 0.0
    for out in outputs:
      tracks = torch.as_tensor(out["tracks"][0], device=self.device)  # [N, T, 2]
      for rh, rw in res:
        levels = [(rh // 4, rw // 4, m["highres_dim"]),
                  (rh // 8, rw // 8, m["lowres_dim"])]
        for _ in range(m["pyramid_level"]):
          gh, gw, c = levels[-1]
          levels.append((gh // 2, gw // 2, c))
        for gh, gw, c in levels:
          cy = (tracks[..., 1] * (gh / h) - 0.5).T.contiguous()  # [T, N]
          cx = (tracks[..., 0] * (gw / w) - 0.5).T.contiguous()
          for s in range(0, n, chunk):
            touched, inside = peaks.corr_touched(
                cy[:, s:s + chunk], cx[:, s:s + chunk], gh, gw,
                m["patch_size"])
            corr += iters * peaks.corr_bound_s(
                touched, inside, t, min(chunk, n - s), c, dtype,
                m["patch_size"])
    return {"corr_tents": corr, "mixer_block": mixer * len(outputs)}

  # ------------------------------------------------------------ correctness

  def compare(self, window, traffic, seed: int) -> Dict[str, float]:
    """Runs the reference over a sample of the window's requests drawn
    from the seed, and returns the gaps between the program's answers and
    the reference's."""
    check = self.cell["check"]
    done = window.outputs
    picks = sorted(random.Random(seed).sample(range(len(done)),
                                              min(check["requests"], len(done))))
    set_precision({"matmul": False, "cudnn": False})
    model = tapir_ref.build(self.model_cfg, self.params, self.device)
    gaps = []
    for i in picks:
      video, qp = traffic.request(window.request_ids[i])
      ref = tapir_ref.track(model, video, qp,
                            self.cell["program"]["refinement_resolutions"],
                            check["query_chunk"], check["frame_chunk"])
      gaps.append(judge.gap(done[i], {k: v.cpu().numpy()
                                      for k, v in ref.items()}))
    del model
    return judge.summarize(gaps, check["block_frames"])

