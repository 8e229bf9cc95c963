"""Each cell at its own size on the card: a short run is correct, and the
control (the reference in bfloat16 in the program's place) is not. Run on
a machine with the card: ``python -m pytest benchmark/tests -m cuda``."""
import json
import time

import pytest
import torch

import harness

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cuda, cell):
    result = harness.run(cell, 2 ** 31 + 11, 2.0, False,
                         started=time.perf_counter(), device=cuda)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda, cell):
    result = harness.run(cell, 2 ** 31 + 13, 2.0, False,
                         started=time.perf_counter(), device=cuda,
                         control=torch.bfloat16)
    assert not result["correct"]
