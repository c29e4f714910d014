"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file: a cell's file, its configuration, family and loop, and a
reader for every metric."""

import os
import re
import sys

import pytest

import harness

SPEC = harness.load_json(harness.REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
  assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
  assert SPEC["paths"] == ["tapbench"]
  assert SPEC["command"] == ["python3", "tapbench/run.py"]
  assert 1 <= SPEC["run_seconds"] <= 51
  cells = len(SPEC["workloads"])
  # The check's time at the full 24 cells fits its 43200 s.
  assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
  assert 1 <= cells <= 24
  assert os.path.getsize(os.path.join(harness.REPO, "BENCHMARK.json")) <= 65536


def test_names_units_and_texts():
  seen = set()
  for group in ("configs", "workloads", "end_to_end", "per_layer"):
    for entry in SPEC[group]:
      assert NAME.match(entry["name"]), entry["name"]
      assert entry["name"] not in seen
      seen.add(entry["name"])
      for key in ("why", "layer", "source"):
        if key in entry and group != "end_to_end" and group != "per_layer":
          assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
  for m in SPEC["end_to_end"] + SPEC["per_layer"]:
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
  for w in SPEC["workloads"]:
    assert 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    assert w["chips"] in (1, 4)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}


def test_end_to_end_bounds():
  names = [m["name"] for m in SPEC["end_to_end"]]
  assert "setup_s" in names
  for m in SPEC["end_to_end"]:
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_the_contract_asks():
  for w in CELLS:
    cell = harness.load_cell(w)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
      assert m["moves"] in e2e, (w, m["name"])


def test_per_layer_metrics_name_their_layer_and_cells():
  e2e = {m["name"] for m in SPEC["end_to_end"]}
  for m in SPEC["per_layer"]:
    assert m["moves"] in e2e
    assert set(m["workloads"]) <= set(CELLS)
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert 1 <= len(m["layer"]) <= 200
    if m["name"].endswith("_roofline"):
      assert m["unit"] == "%"


def test_configs_are_used_and_stand_alone():
  used = {w["config"] for w in SPEC["workloads"]}
  assert used == {c["name"] for c in SPEC["configs"]}
  files = [c["file"] for c in SPEC["configs"]]
  assert len(set(files)) == len(files)
  for c in SPEC["configs"]:
    assert c["file"].startswith("tapbench/")
    body = harness.load_json(harness.REPO, c["file"])
    assert body["name"] == c["name"] and body["source"] == c["source"]
    assert body["reduced"] == c["reduced"] == []
    assert "assumed" in body


@pytest.mark.parametrize("workload", CELLS)
def test_discovery_by_name(workload):
  cell = harness.load_cell(workload)
  assert cell.cell["why"] == cell.workload["why"]
  harness.load_module("families", cell.config["family"])
  harness.load_module("loops", cell.cell["loop"])
  for m in cell.end_to_end + cell.per_layer:
    assert callable(harness.load_module("metrics", m["name"]).read)
  assert cell.cell["limits"]


def test_unknown_names_are_refused():
  with pytest.raises(KeyError):
    harness.load_cell("no-such.cell")
  with pytest.raises(FileNotFoundError):
    harness.load_module("metrics", "no_such_metric")


def test_files_under_paths_are_named_from_name_characters():
  for root, _, files in os.walk(harness.HERE):
    for f in files:
      rel = os.path.relpath(os.path.join(root, f), harness.REPO)
      if "__pycache__" in rel or "/_cache/" in rel:
        continue
      assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_module_check_compares_whole_top_level_names(monkeypatch):
  assert harness.forbidden_modules() == [] or "jax" in sys.modules
  monkeypatch.setitem(sys.modules, "tapnet_tpu_torch_like", object())
  monkeypatch.setitem(sys.modules, "jaxtyping", object())
  monkeypatch.setitem(sys.modules, "tapnet_tpu_torch.inference", object())
  assert "tapnet_tpu" not in harness.forbidden_modules()
  assert "jaxtyping" not in harness.forbidden_modules()
  monkeypatch.setitem(sys.modules, "tapnet_tpu.models.tapir", object())
  monkeypatch.setitem(sys.modules, "flax.linen", object())
  assert {"tapnet_tpu", "flax"} <= set(harness.forbidden_modules())
  with pytest.raises(harness.Forbidden):
    harness.check_modules("test")


def test_the_harness_imports_no_jax():
  import subprocess  # pylint: disable=import-outside-toplevel
  code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
          "import harness, judge, peaks, traffic, device_trace; "
          "import tapnet_tpu_torch.inference; "
          "[harness.load_module(k, n) for k, n in (('families', 'tapir'), "
          "('families', 'tapnext'), ('loops', 'offline'), ('loops', 'online'))]; "
          "print(harness.forbidden_modules())")
  out = subprocess.run([sys.executable, "-c", code, harness.HERE, harness.REPO],
                       capture_output=True, text=True, check=True, timeout=300)
  assert out.stdout.strip() == "[]"
