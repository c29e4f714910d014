"""The frozen references against the port's plain CPU paths at a tiny
size: the same function on the same inputs and weights. The port is
imported here only, to be compared with; the references import nothing of
it."""

import ast
import os

import numpy as np
import torch

import harness
from families import tapnext as tapnext_family
from families import tapir as tapir_family
from reference import tapir_ref, tapnext_ref
from traffic import Traffic


def test_references_import_nothing_of_the_program():
  for name in ("tapir_ref.py", "tapnext_ref.py"):
    tree = ast.parse(open(os.path.join(harness.HERE, "reference", name)).read())
    roots = set()
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        roots |= {a.name.split(".")[0] for a in node.names}
      elif isinstance(node, ast.ImportFrom):
        roots.add((node.module or "").split(".")[0])
    assert roots <= {"__future__", "typing", "itertools", "numpy", "torch"}, roots


def _video(frames, size, queries, seed=5):
  traffic = {"pool": 1, "frames": frames, "height": size, "width": size,
             "sprites": 3, "velocity_px": 1.0, "queries": queries,
             "query_frames": "uniform", "query_layout": "random",
             "margin": 4, "requests": 1}
  return Traffic(traffic, seed, torch.device("cpu")).request(0)


def test_tapir_reference_is_the_port_plain_path():
  from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
  from tapnet_tpu_torch.models import tapir  # pylint: disable=import-outside-toplevel
  cfg = harness.load_json(harness.HERE, "configs", "bootstapir.json")
  params = tapir_family.load_params(cfg["weights"]["file"])
  torch.manual_seed(0)
  video, qp = _video(3, 64, 6)
  kwargs = {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["model"].items()}
  port = inference.TapirPredictor(params, tapir.TapirConfig(**kwargs),
                                  query_chunk_size=4,
                                  refinement_resolutions=[(64, 64)],
                                  device="cpu")(video, qp)
  model = tapir_ref.build(cfg["model"], params, "cpu")
  ref = tapir_ref.track(model, video, qp, [[64, 64]], query_chunk=3,
                        frame_chunk=2)
  for key in ("tracks", "occlusion", "expected_dist"):
    np.testing.assert_allclose(port[key], ref[key].numpy(), atol=1e-4,
                               rtol=1e-5)


def _tiny_tapnext():
  cfg = harness.load_json(harness.HERE, "configs", "tapnext-b.json")
  model = dict(cfg["model"], width=32, depth=2, mlp_dim=64, num_heads=2,
               image_size=[32, 32], compute_dtype="float32")
  return model, tapnext_family.seeded_params(model, 7, "cpu")


def test_tapnext_reference_is_the_port_plain_path():
  from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
  model, params = _tiny_tapnext()
  video, qp = _video(7, 32, 5)
  port = inference.TapnextPredictor(params, tapnext_family._port_config(model),
                                    chunk_size=3, device="cpu")(video, qp)
  ref = tapnext_ref.build(model, params, "cpu")
  tracks, occ = tapnext_ref.track(ref, video, qp, chunk=4)
  np.testing.assert_allclose(port["occlusion"], occ.numpy(), atol=1e-4)
  d = np.linalg.norm(port["tracks"] - tracks.numpy(), axis=-1)
  # A near-tied coordinate bin of the random-weight head may flip.
  assert np.mean(d < 1e-3) >= 0.97


def test_tapnext_stream_is_the_whole_clip():
  from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
  model, params = _tiny_tapnext()
  video, qp = _video(6, 32, 4)
  qp = qp.clone()
  qp[..., 0] = 0
  online = inference.OnlineTapnextPredictor(
      params, tapnext_family._port_config(model), device="cpu")
  got = [online.init(video[:, :1], qp)[0][:, :, 0]]
  got += [online.step(video[:, t])[0] for t in range(1, 6)]
  got = np.stack(got, 2)[..., ::-1]  # (x, y)
  ref = tapnext_ref.build(model, params, "cpu")
  tracks, _ = tapnext_ref.track(ref, video, qp, chunk=4)
  d = np.linalg.norm(got - tracks.numpy(), axis=-1)
  assert np.mean(d < 1e-3) >= 0.97


def test_control_precision_moves_the_answer():
  model, params = _tiny_tapnext()
  video, qp = _video(4, 32, 4)
  ref = tapnext_ref.build(model, params, "cpu")
  _, occ = tapnext_ref.track(ref, video, qp, chunk=4)
  _, occ8 = tapnext_ref.track(ref, video, qp, chunk=4, vit_precision="fp8")
  gap = np.abs(occ.numpy() - occ8.numpy())
  assert np.median(gap) > 1e-3
