"""The control of each cell: the step below the configuration's precision
put in the program's place (TAPIR: the program's bfloat16 path; TAPNext:
the reference with float8 ViT products) has to come out not correct.

On the card, at the cell's own sizes, load and window, on three seeds:
`python -m pytest -m gpu tapbench/tests/test_tapbench_control.py`. On the
CPU, at the rehearsal's tiny sizes, the control has to read further from
the reference than the program on every number the cell compares."""

import pytest

import harness
from conftest import REHEARSAL

SPEC = harness.load_json(harness.REPO, "BENCHMARK.json")
CELLS = sorted(set(REHEARSAL) & {w["name"] for w in SPEC["workloads"]})
SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103)


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_further_than_the_program(workload):
  seed = 2**31 + 21
  sound = harness.run(workload, seed, 0.5, False, "cpu", 0.0,
                      **REHEARSAL[workload])
  control = harness.run(workload, seed, 0.5, False, "cpu", 0.0, control=True,
                        **REHEARSAL[workload])
  for name in harness.load_cell(workload).cell["limits"]:
    assert control["stats"][name] > sound["stats"][name], name


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(workload, card):
  for seed in SEEDS:
    result = harness.run(workload, seed, SPEC["run_seconds"], False, card, 0.0,
                         control=True)
    assert not result["correct"], (seed, result["checks"])
