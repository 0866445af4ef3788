"""The port's explicit feature maps (repro_torch/core/feature_maps.py)
against repro.core.feature_maps: random Fourier features from the same
seed agree to 1e-5 (Omega's normal draws agree with JAX's to float32
rounding, b's uniform draws bit for bit); the linear and backbone maps
pass their inputs through."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feature_maps as jfm
from repro_torch.core import feature_maps as tfm


@pytest.mark.parametrize("d_in, d_out, gamma, seed", [
    (16, 64, 1.0, 0), (7, 33, 0.3, 5), (100, 256, 0.05, 17),
])
def test_rff_map_equals_jax(d_in, d_out, gamma, seed):
    x = (np.random.RandomState(seed).randn(50, d_in) / np.sqrt(d_in)).astype(np.float32)
    want = np.asarray(jfm.rff_map(d_in, d_out, gamma, seed).apply(jnp.asarray(x)))
    fmap = tfm.rff_map(d_in, d_out, gamma, seed)
    assert fmap.name == "rff" and fmap.dim_out == d_out
    got = fmap.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the shared seed is the whole map: a rebuilt map gives the same phi
    np.testing.assert_array_equal(tfm.rff_map(d_in, d_out, gamma, seed).apply(
        torch.from_numpy(x)).numpy(), got)


def test_rff_kernel_approximation():
    """phi(x).phi(x') approximates exp(-gamma |x - x'|^2)."""
    rs = np.random.RandomState(0)
    x = rs.randn(20, 5).astype(np.float32) * 0.3
    phi = tfm.rff_map(5, 4096, gamma=0.5, seed=1).apply(torch.from_numpy(x)).numpy()
    K = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1))
    assert np.abs(phi @ phi.T - K).max() < 0.1


def test_apply_to_tasks_and_pass_through_maps():
    xs = [np.random.RandomState(i).randn(3 + i, 8).astype(np.float32) for i in range(3)]
    fmap = tfm.rff_map(8, 12, 1.0, 2)
    got = tfm.apply_to_tasks(fmap, xs, device="cpu")
    want = jfm.apply_to_tasks(jfm.rff_map(8, 12, 1.0, 2), xs)
    for g, w, x in zip(got, want, xs):
        assert isinstance(g, np.ndarray) and g.shape == (x.shape[0], 12)
        np.testing.assert_allclose(g, w, atol=1e-5)
    lin = tfm.linear_map(8)
    assert lin.dim_out == 8
    for g, x in zip(tfm.apply_to_tasks(lin, xs, device="cpu"), xs):
        np.testing.assert_array_equal(g, x)
    bb = tfm.backbone_map(lambda t: t[:, :4] * 2, 4)
    assert bb.name == "backbone" and bb.dim_out == 4
    np.testing.assert_array_equal(tfm.apply_to_tasks(bb, xs, device="cpu")[0], 2 * xs[0][:, :4])
