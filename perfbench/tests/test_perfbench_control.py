"""The control: the reference in TF32 put in the program's place must come
out not correct, and so must the program with each fault of ``faults.py``
planted, while the program comes out correct.

On the CPU at a small size, three seeds: the control reads at least ten
times what the program reads on some compared number. On the card (marker
``gpu``), at each cell's own size, three seeds: the program holds every
limit of ``limits/<cell>.json``, and the control and each fault break at
least one.

    python -m pytest perfbench/tests                 # the CPU part
    python -m pytest -m gpu perfbench/tests          # on a machine with a card
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import control, spec  # noqa: E402

# the paper's Omega-step with fewer tasks than features, as both cells run it
SMALL = {"generator": "synthetic1", "lam": 1e-3,
         "params": {"m": 16, "d": 64, "n_train_avg": 100, "n_test_avg": 20}}


def small_cell() -> spec.Cell:
    traffic = spec.load_json(spec.HERE / "traffic" / "paper_omega.json")
    traffic.update(outer_iters=2, rounds=4, track_every=4)
    return spec.Cell("small", 1, SMALL, traffic, {}, [], [])


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_separates_from_the_program(seed):
    line = control.readings(small_cell(), seed, "cpu")
    ratios = {k: line["control"][k] / max(line["program"][k], 1e-300) for k in line["program"]}
    assert max(ratios.values()) >= 10.0, line


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_and_faults_fail_the_cell_limits(card, name, seed):
    from perfbench import check, faults

    cell = spec.cell(name)
    line = control.readings(cell, seed, card, faults=faults.NAMES)

    def holds(which):
        return all(v["ok"] for v in check.judge(line[which], cell.limits).values())

    assert holds("program"), line
    for which in ("control",) + faults.NAMES:
        assert not holds(which), (which, line)
