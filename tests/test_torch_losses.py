"""repro_torch.core.losses against repro.core.losses: five losses x five
functions on the same numpy inputs, float32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl

LOSSES = ("hinge", "squared", "smoothed_hinge", "logistic", "eps_insensitive")
FUNCS = ("value", "conjugate", "sdca_delta", "dual_feasible", "subgradient")


def _inputs(loss_name, n=400, seed=0):
    rs = np.random.RandomState(seed)
    cls = jl.get_loss(loss_name).is_classification
    y = np.where(rs.randn(n) > 0, 1.0, -1.0) if cls else rs.randn(n)
    z = 2.0 * rs.randn(n)
    # dual values inside each loss's domain for the conjugate
    if loss_name in ("hinge", "smoothed_hinge", "logistic"):
        alpha = y * rs.uniform(0.01, 0.99, n)
        u = -alpha
    elif loss_name == "eps_insensitive":
        u = rs.uniform(-1, 1, n)
        alpha = -u
    else:
        u = rs.randn(n)
        alpha = -u
    atilde = alpha
    c = rs.randn(n)
    a = rs.uniform(0.05, 3.0, n)
    f32 = lambda v: np.asarray(v, np.float32)
    return dict(y=f32(y), z=f32(z), u=f32(u), alpha=f32(alpha),
                atilde=f32(atilde), c=f32(c), a=f32(a))


def _args(fn, v):
    return {
        "value": (v["z"], v["y"]),
        "conjugate": (v["u"], v["y"]),
        "sdca_delta": (v["atilde"], v["c"], v["a"], v["y"]),
        "dual_feasible": (3.0 * v["alpha"], v["y"]),
        "subgradient": (v["z"], v["y"]),
    }[fn]


@pytest.mark.parametrize("fn", FUNCS)
@pytest.mark.parametrize("loss_name", LOSSES)
def test_loss_function_matches_jax(loss_name, fn):
    v = _inputs(loss_name)
    args = _args(fn, v)
    jfn = getattr(jl.get_loss(loss_name), fn)
    # the JAX functions are written per coordinate (eps_insensitive's argmax
    # flattens), so vmap them over the batch
    ref = np.asarray(jax.vmap(jfn)(*[jnp.asarray(a) for a in args]))
    got = getattr(tl.get_loss(loss_name), fn)(*[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=2e-6)


def test_registry_and_constants():
    assert set(tl.registered_losses()) == set(jl.registered_losses())
    for name in LOSSES:
        a, b = tl.get_loss(name), jl.get_loss(name)
        assert (a.smoothness_mu, a.lipschitz, a.is_classification) == (
            b.smoothness_mu, b.lipschitz, b.is_classification)
    assert (tl._EPS, tl._GAMMA, tl._NEWTON_STEPS, tl._EPS_TUBE) == (
        jl._EPS, jl._GAMMA, jl._NEWTON_STEPS, jl._EPS_TUBE)
    with pytest.raises(KeyError, match="unknown loss"):
        tl.get_loss("nope")


@pytest.mark.parametrize("loss_name", LOSSES)
def test_sdca_delta_improves_the_coordinate_objective(loss_name):
    """The delta is an ascent step on the scalar dual subproblem."""
    v = _inputs(loss_name, n=200, seed=3)
    loss = tl.get_loss(loss_name)
    at, c, a, y = (torch.from_numpy(v[k]) for k in ("atilde", "c", "a", "y"))
    at = loss.dual_feasible(at, y)
    delta = loss.sdca_delta(at, c, a, y)

    def f(d):
        return -loss.conjugate(-(at + d), y) - c * d - 0.5 * a * d**2

    assert torch.all(f(delta) >= f(torch.zeros_like(delta)) - 1e-4)
