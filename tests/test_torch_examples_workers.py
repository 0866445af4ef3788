"""The port's mesh examples, examples/torch/distributed_workers.py and
async_workers.py, on the CPU.

Their JAX twins fail on the installed jax (ROADMAP RC1: the mesh engines'
``shard_map`` raises ``ShardingTypeError``), so the port's examples are
held to the port's own anchors in one 4-rank gloo world for the module
(tests/torch_example_ranks.py; the examples take that world as their
``data`` axis, as they take a ``torchrun`` one):

  * distributed_workers: the distributed engine's W against the reference
    engine's (``dmtrl.fit``) at the fit bar (2e-4); its gap falls; every
    rank returns the same numbers;
  * async_workers: the synchronous history equal to ``fit_distributed``'s
    on the same world and config; the async engine reaches the target gap
    in no more ticks than the synchronous one; the threaded server's max
    lag is at most tau (2); the trace holds spans;
  * the spectral gaps of ring, torus and complete over 8 nodes equal the
    JAX package's ``repro.core.gossip.spectral_gap`` (no mesh needed).

Without a world the examples take the local one-position mesh. Without a card, ``--device cuda``
(the default) raises before any work.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.gossip import build_adjacency, mixing_matrix, spectral_gap
from torch_examples_util import REPO, port_example

TOL_W = 2e-4  # the fit bar (tests/test_distributed.py)
TAU = 2  # async_workers' staleness bound


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("example_ranks")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")])}
    proc = subprocess.run(
        [sys.executable, "-c", f"import torch_example_ranks as r; r.main({str(out)!r})"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = []
    for r in range(4):
        with open(out / f"rank{r}.json") as f:
            res.append(json.load(f))
    return res, out


def test_distributed_workers_over_four_ranks(ranks):
    res, _ = ranks
    dw = [r["distributed_workers"] for r in res]
    assert [d["rank"] for d in dw] == [0, 1, 2, 3] and {d["world"] for d in dw} == {4}
    for d in dw[1:]:
        assert {k: v for k, v in d.items() if k != "rank"} == {
            k: v for k, v in dw[0].items() if k != "rank"}
    assert dw[0]["max_abs_w_diff"] <= TOL_W
    assert dw[0]["gap_last"] < dw[0]["gap_first"] and len(dw[0]["gap"]) == 3 * 8


def test_async_workers_over_four_ranks(ranks):
    res, out_dir = ranks
    aw = [r["async_workers"] for r in res]
    assert {a["world"] for a in aw} == {4} and aw[0]["delays"] == [1, 1, 1, 4]
    for r, a in zip(res, aw):
        np.testing.assert_allclose(a["sync_gap"], r["fit_distributed_gap"], rtol=0, atol=0)
        assert a["sync_gap"] == aw[0]["sync_gap"]
        assert a["ticks_async"] == aw[0]["ticks_async"]
    a = aw[0]
    assert a["ticks_async"] <= a["ticks_sync"]
    assert a["staleness"]["max_lag"] <= TAU
    # the host transports run once, on rank 0
    assert all("threaded" not in x for x in aw[1:])
    assert a["threaded"]["max_lag"] <= TAU
    assert np.isfinite(a["threaded"]["final_gap"]) and np.isfinite(a["gossip"]["final_gap"])
    assert a["gossip"]["n_exchanges"] > 0
    with open(out_dir / "trace.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert a["trace"]["spans"] > 0 and len(events) >= a["trace"]["spans"]
    assert {row["name"] for row in a["trace"]["top"]} & {"round", "solve", "commit"}


def test_spectral_gaps_match_jax(ranks):
    gaps = ranks[0][0]["async_workers"]["spectral_gaps"]
    for topo, g in gaps.items():
        want = spectral_gap(mixing_matrix(build_adjacency(topo, 8)))
        assert g == pytest.approx(want, abs=1e-12), topo


def test_without_a_world_the_mesh_is_one_local_position(monkeypatch):
    """What ``python examples/torch/distributed_workers.py`` (no torchrun)
    runs on: the local mesh, no process group made."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    port_example("distributed_workers")  # puts examples/torch on the path
    from _common import data_mesh

    with data_mesh(torch.device("cpu")) as (mesh, rank):
        assert dict(mesh.shape) == {"data": 1} and rank == 0
        assert mesh.group("data") is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name, args", [
    ("distributed_workers", []),
    ("async_workers", ["--tiny"]),
])
def test_runs_on_the_card_unless_asked(name, args, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = port_example(name)
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)
    assert capsys.readouterr().out == ""  # raised before any work
