"""roofline.analysis: the roofline terms against the H100's constants, the
cost counter's rules, the collectives' byte counter, and the kernel
dispatchers' meta branches and formulas."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.sdca import ops as sdca_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import CostCounter, Costs, RooflineTerms, roofline_terms

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
META = torch.device("meta")


def _terms(flops=0, nbytes=0, coll=0, n_chips=1, model_flops=0.0):
    c = Costs(flops=flops, bytes=nbytes)
    c.collective_bytes["all_gather"] = coll
    c.collectives["all_gather"] = 1 if coll else 0
    return roofline_terms(c, arch="a", shape="s", mesh_name="m", n_chips=n_chips,
                          model_flops=model_flops)


def test_terms_have_the_jax_fields():
    from repro.roofline.analysis import RooflineTerms as JaxTerms

    jax_fields = {f.name for f in dataclasses.fields(JaxTerms)}
    port_fields = {f.name for f in dataclasses.fields(RooflineTerms)}
    assert jax_fields <= port_fields
    row = _terms(flops=10, nbytes=10).to_row()
    assert set(row) == port_fields and row["xla_flops_raw"] == 0.0


@pytest.mark.parametrize("kind,costs", [
    ("compute", dict(flops=int(989e12), nbytes=int(1e9), coll=int(1e8))),
    ("memory", dict(flops=int(1e12), nbytes=int(3.35e12), coll=int(1e8))),
    ("collective", dict(flops=int(1e12), nbytes=int(1e9), coll=int(450e9))),
])
def test_dominant_term(kind, costs):
    t = _terms(**costs)
    assert t.dominant == kind
    assert {"compute": t.compute_s, "memory": t.memory_s, "collective": t.collective_s}[kind] \
        == pytest.approx(1.0)


def test_terms_read_the_h100_constants_of_launch_mesh(monkeypatch):
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.NVLINK_BW) == (989e12, 3.35e12,
                                                                              450e9)
    t = _terms(flops=2 * 10**12, nbytes=10**12, coll=10**9, n_chips=4, model_flops=4e12)
    assert t.compute_s == 2e12 / mesh_mod.PEAK_FLOPS_BF16
    assert t.memory_s == 1e12 / mesh_mod.HBM_BW
    assert t.collective_s == 1e9 / mesh_mod.NVLINK_BW
    assert t.useful_flops_ratio == pytest.approx(4e12 / (4 * 2e12))
    monkeypatch.setattr(mesh_mod, "PEAK_FLOPS_BF16", 1e12)
    assert _terms(flops=10**12).compute_s == 1.0


def _numbers(path: Path):
    tree = ast.parse(path.read_text())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, (int, float))}


@pytest.mark.parametrize("rel", ["roofline/analysis.py", "launch/mesh.py", "launch/dryrun.py",
                                 "launch/dryrun_dmtrl.py", "launch/input_specs.py"])
def test_no_tpu_number(rel):
    """No constant of the JAX package's TPU roofline (197e12 FLOP/s, 819e9
    and 50e9 bytes/s) and no TPU name in the port's roofline modules."""
    path = PORT / rel
    assert not _numbers(path) & {197e12, 819e9, 50e9}
    code = "\n".join(line for line in path.read_text().splitlines()
                     if not line.lstrip().startswith("#"))
    for word in ("TPU", "v5e", "ICI_BW"):
        assert word not in code, (rel, word)


# ---------------------------------------------------------------------------
# the counter's rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_flops_and_bytes(device):
    a = torch.ones((8, 16), device=device)
    b = torch.ones((16, 4), device=device)
    with CostCounter() as c:
        a @ b
    assert c.costs.flops == 2 * 8 * 16 * 4
    assert c.costs.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert c.costs.ops == 1 and c.costs.peak_bytes == 4 * 8 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_views_allocations_and_host_copies_move_nothing(device):
    x = torch.ones((6, 4), device=device)
    with CostCounter() as c:
        x.view(24)
        x.t()
        x[1:3]
        torch.empty((100,), device=device)
        torch.ones((3,)).to(device)  # a host copy on meta, none on the CPU
    assert c.costs.bytes == 4 * 3  # ones((3,)) on the host, written once
    assert c.costs.flops == 0


def test_inplace_and_repeated_inputs():
    x = torch.ones((10,))
    y = torch.ones((1,)).expand(10)  # stride 0: one element read
    with CostCounter() as c:
        x.add_(y)
    assert c.costs.bytes == 4 * (10 + 1) + 4 * 10
    with CostCounter() as c:
        x * x  # one tensor passed twice is read once
    assert c.costs.bytes == 4 * 10 + 4 * 10


def test_peak_live_bytes():
    with CostCounter() as c:
        a = torch.zeros((1000,))  # 4000
        b = torch.zeros((500,))  # 2000: 6000 live
        del a
        d = torch.zeros((750,))  # 5000 live
        del b, d
        e = torch.zeros((1500,))  # 6000 live
        del e
    assert c.costs.peak_bytes == 6000


def test_one_counter_at_a_time_and_active_is_cleared():
    with pytest.raises(RuntimeError, match="already active"):
        with CostCounter():
            assert analysis.ACTIVE is not None
            with CostCounter():
                pass
    assert analysis.ACTIVE is None
    with pytest.raises(ZeroDivisionError):
        with CostCounter():
            1 / 0
    assert analysis.ACTIVE is None


def test_launch_counts_once_and_hides_its_ops():
    x = torch.ones((32, 32))

    def plain():
        y = x @ x
        with_inner = analysis.ACTIVE.launch("inner", (5, 5), lambda: x @ x)
        return y, with_inner

    with CostCounter() as c:
        c.launch("K", (1000, 64), plain)
        x @ x
    assert c.costs.kernels == {"K": 1}  # the inner launch ran in K's plain version
    assert c.costs.flops == 1000 + 2 * 32 ** 3
    assert c.costs.bytes == 64 + 2 * 4 * 32 * 32  # x read once, x @ x written


def test_collective_bytes_on_a_fake_world():
    from repro_torch.core import make_mesh
    from repro_torch.launch import fake_world

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="meta")
        t = torch.empty((3, 5), device=META)
        with CostCounter() as c:
            dist_mod.all_gather(t, mesh, "data")
            dist_mod.psum(t, mesh, "model")
            dist_mod.psum_scatter(torch.empty((4, 5), device=META), mesh, "model", 0)
            dist_mod.all_gather_dim(t, mesh, "model", 1)
            dist_mod.broadcast(t, mesh)
    assert c.costs.collectives == {"all_gather": 2, "all_reduce": 2, "broadcast": 1}
    # the larger of the tensor sent and the one received: the gathered one
    assert c.costs.collective_bytes == {"all_gather": 2 * 4 * 30, "all_reduce": 4 * (15 + 20),
                                        "broadcast": 4 * 15}


# ---------------------------------------------------------------------------
# the kernels' dispatchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (64, 16), (100, 100), (100, 1), (33, 40)])
def test_kept_pairs_closed_form(S, window):
    assert flash_ops.kept_pairs(S, S, True, window) == sum(
        min(i + 1, window or S) for i in range(S))
    assert flash_ops.kept_pairs(S, 2 * S, False, window) == 2 * S * S


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_flash_meta_branch_counts_k3(causal, window):
    B, S, H, HD = 2, 24, 3, 16
    q, k, v = (torch.empty((B, S, H, HD), device=META, requires_grad=True) for _ in range(3))
    with CostCounter() as c:
        out = flash_ops.flash_attention_bshd(q, k, v, causal, window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert out.shape == q.shape and out.is_contiguous()
    assert all(g.shape == q.shape for g in (dq, dk, dv))
    assert c.costs.kernels == {"K3": 1, "K3-bwd": 1}
    assert c.costs.kernel_flops["K3"] == flash_ops.k3_cost(B, H, S, S, HD, causal, window, 4,
                                                           True)[0]
    assert c.costs.kernel_bytes["K3-bwd"] == flash_ops.k3_bwd_cost(B, H, S, S, HD, causal,
                                                                   window, 4)[1]
    # the BHSD dispatcher too
    qt = torch.empty((B, H, S, HD), device=META)
    assert flash_ops.flash_attention(qt, qt, qt, causal, window, 8, 8).shape == qt.shape


def test_ssd_meta_branches_match_the_cpu_shapes():
    B, L, H, G, P, N, Q = 1, 40, 4, 2, 8, 6, 16
    torch.manual_seed(0)
    cpu = [torch.randn(B, L, H, P), torch.rand(B, L, H), -torch.rand(H),
           torch.randn(B, L, G, N), torch.randn(B, L, G, N)]
    outs = {}
    for dev in ("cpu", "meta"):
        args = [t.to(dev).requires_grad_(True) for t in cpu]
        with CostCounter() as c:
            y = ssd_ops.SSDChunk.apply(*args, Q)
            grads = torch.autograd.grad(sum(t.sum() for t in y) if dev == "cpu" else y,
                                        args, None if dev == "cpu" else
                                        [torch.empty_like(t) for t in y])
        outs[dev] = ([(t.shape, t.dtype, t.stride()) for t in y],
                     [(g.shape, g.dtype) for g in grads], c.costs.kernels)
    assert outs["cpu"] == outs["meta"]
    assert outs["meta"][2] == {"K4": 1, "K4-bwd": 1}
    # the chunked-layout dispatcher
    x = torch.empty((B, H, 2, Q, P), device=META)
    dt = torch.empty((B, H, 2, Q), device=META)
    Bm = torch.empty((B, H, 2, Q, N), device=META)
    with CostCounter() as c:
        y, s, a = ssd_ops.ssd_chunk(x, dt, torch.empty(H, device=META), Bm, Bm)
    assert (y.shape, s.shape, a.shape) == ((B, H, 2, Q, P), (B, H, 2, N, P), (B, H, 2))
    assert c.costs.kernel_flops["K4"] == ssd_ops.k4_cost(B, 2 * Q, H, H, P, N, Q, 4)[0]


def test_sdca_meta_branches():
    m, n, d, H, Bk = 3, 20, 7, 8, 4
    f = lambda *s: torch.empty(s, device=META)
    with CostCounter() as c:
        dalpha, r = sdca_ops.sdca_round(f(m, n, d), f(m, n), f(m, n), f(m, d), f(m, H),
                                        torch.empty(m, dtype=torch.int32, device=META),
                                        f(m), "hinge", block=Bk)
        deltas = sdca_ops.sdca_block_apply(f(m, Bk, d), f(m, d), f(m, d), f(m, Bk), f(m, Bk),
                                           torch.empty((m, Bk), dtype=torch.long, device=META),
                                           f(m), "hinge")
    assert (dalpha.shape, r.shape, deltas.shape) == ((m, n), (m, d), (m, Bk))
    assert c.costs.kernels == {"K1": 1, "K2": 1}
    assert c.costs.kernel_flops["K1"] == sdca_ops.k1_cost(m, n, d, H, Bk, 4)[0]
    assert c.costs.kernel_bytes["K2"] == sdca_ops.k2_cost(m, Bk, d, 4)[1]
