"""The round's coordinate draw kernel (repro_torch.kernels.prng,
csrc/threefry_draw.cu).

On the CPU: the wrapper refuses tensors off the card. On a CUDA card
(marker ``gpu``; they skip here): the kernel's uniforms bit-equal to the
CPU path (prng's torch ops, which tests/test_torch_prng.py holds against
jax.random) at both benchmark cells' shapes, an odd H, pod != 0, one task,
and more tasks than one grid column; and a fit at the benchmark's
``paper_omega`` settings launching it once a worker round on the reference
engine, the mesh engine and the threaded transport. This module imports no
JAX, so the card's run, which has none, can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_prng_kernel.py
"""
import pytest
import torch

from repro_torch import prng
from repro_torch.core.solver_backends import draw_task_uniform
from repro_torch.kernels.prng import threefry_draw
from repro_torch.kernels.sdca import sdca_round_kernel


def test_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        threefry_draw(prng.PRNGKey(0), torch.arange(3, dtype=torch.int32), 0, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (m, H, first task id, pod)
CASES = [
    (10, 12032, 0, 0),  # mnist.fit
    (16, 2048, 0, 0),  # synthetic1.fit
    (3, 1001, 0, 0),  # H odd: stored one float at a time
    (7, 4096, 5, 3),  # ids from an offset, pod != 0
    (1, 1, 0, 0),
    (1, 12032, 9, 0),
    (65537, 8, 0, 1),  # more tasks than gridDim.y holds
]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
@pytest.mark.parametrize("m, H, first, pod", CASES)
def test_draw_bit_equal_to_cpu_path(cuda, seed, m, H, first, pod):
    key = prng.split(prng.PRNGKey(seed), 10)[3]
    tids = torch.arange(first, first + m, dtype=torch.int32)
    before = threefry_draw.launches
    got = draw_task_uniform(key, tids.to(cuda), pod, H, cuda)
    torch.cuda.synchronize()
    assert threefry_draw.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = draw_task_uniform(key, tids, pod, H, "cpu")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["reference", "distributed", "async"])
def test_fit_draws_once_a_round(cuda, engine):
    """P = 4 outer steps x T = 10 rounds through K1 (``pallas_round``), the
    paper's Omega-step: one draw launch and one K1 launch a worker round,
    so 40 of each a fit on the reference engine and the one-device mesh
    engine, and 80 on the threaded transport's two workers."""
    from repro_torch.core import AsyncOptions, DMTRLEstimator
    from repro_torch.data.synthetic import synthetic

    train = synthetic(1, seed=0).train.to(cuda)
    workers = 2 if engine == "async" else 1
    opts = {}
    if engine == "async":
        opts = dict(async_options=AsyncOptions(transport="threaded", n_workers=workers))
    est = DMTRLEstimator(
        engine=engine, device=cuda, regularizer="trace_constraint", loss="hinge",
        lam=1e-3, solver="pallas_round", outer_iters=4, rounds=10, local_iters=0,
        block_size=64, track_every=10, seed=2**31 + 7, **opts,
    )
    draws, rounds = threefry_draw.launches, sdca_round_kernel.launches
    est.fit(train)
    torch.cuda.synchronize()
    assert threefry_draw.launches - draws == 40 * workers
    assert sdca_round_kernel.launches - rounds == 40 * workers
    assert bool(torch.isfinite(est.W_).all())
