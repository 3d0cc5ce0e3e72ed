"""The control on the card: each cell at its own size and window, on three
seeds, with the program's bfloat16 storage switched on (the nearest
precision below the float32 the configurations state), must come out not
correct. Each run prints its readings, the upper ends of the limits in
``checks/<cell>.json``:

    python3 -m pytest benchmark/tests -m card -s
"""

import json

import pytest
import torch

from benchmark.cells import Cell, benchmark_spec
from benchmark.harness import run_cell

SPEC = benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = [2 ** 31 + 77, 2 ** 31 + 78, 2 ** 31 + 79]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    line = run_cell(Cell(cell), seed, float(SPEC["run_seconds"]), False,
                    torch.device("cuda", 0), storage_dtype="bfloat16")
    print(f"control {cell} {seed} " + json.dumps(
        {n: c["value"] for n, c in line["checks"].items()}))
    assert not line["correct"], line["checks"]
