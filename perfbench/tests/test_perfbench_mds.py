"""The ``mds`` configuration on the CPU: its generator's fixed domain sizes
and reviews, its cell run whole at a size the CPU takes, and the readers of
its two metrics on a canned record.

    python -m pytest perfbench/tests/test_perfbench_mds.py
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import peaks, spec  # noqa: E402
from perfbench.data import mds_like  # noqa: E402

CELL = spec.cell("mds.fit")
PARAMS = CELL.config["params"]
# the cell's reviews at a tenth of a domain's rows and a thirtieth of the
# words: the same generator, a size the CPU fits in seconds
SMALL = dict(PARAMS, d=300, nnz=8, n_min=20, n_max=90)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_domain_sizes_fixed_across_seeds(seed):
    sizes = mds_like.domain_sizes(PARAMS["m"], PARAMS["n_min"], PARAMS["n_max"])
    assert len(sizes) == 22 and sizes.min() == 314 and sizes.max() == 20751
    assert np.array_equal(sizes, mds_like.domain_sizes(22, 314, 20751))
    # the seed only orders them over the domains
    arr = mds_like.generate(**dict(PARAMS, n_min=31, n_max=2075), seed=seed)
    got = sorted(len(a) + len(b) for a, b in zip(arr.ytr, arr.yte))
    assert got == sorted(mds_like.domain_sizes(22, 31, 2075).tolist())
    assert [len(a) for a in arr.ytr] == [int(0.7 * (len(a) + len(b)))
                                         for a, b in zip(arr.ytr, arr.yte)]


def test_reviews_are_bags_of_270_words():
    arr = mds_like.generate(**dict(PARAMS, n_min=31, n_max=300), seed=5)
    for x, y in zip(arr.xtr + arr.xte, arr.ytr + arr.yte):
        assert x.shape[1] == 10000 and x.dtype == np.float32
        assert ((x != 0).sum(axis=1) == 270).all()
        np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, rtol=1e-5)
        assert set(np.unique(y)) <= {-1.0, 1.0}
    v = np.concatenate([x[x != 0] for x in arr.xtr])
    # U[0.2, 1.2) over 270 words, normalised: each in [0.2, 1.2] / sqrt(270 * 1.2^2)
    assert v.min() > 0.2 / np.sqrt(270 * 1.44) and v.max() < 1.2 / np.sqrt(270 * 0.04)
    labels = np.concatenate(arr.ytr + arr.yte)
    assert 0.2 < (labels > 0).mean() < 0.8


def test_distinct_columns_are_uniform_subsets():
    cols = mds_like.distinct_columns(np.random.RandomState(0), 4000, 50, 20)
    assert all(len(set(r)) == 20 for r in cols)
    counts = np.bincount(cols.ravel(), minlength=50) / cols.size
    np.testing.assert_allclose(counts, 1 / 50, atol=0.004)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_mds_cell_is_correct_on_the_cpu(seed):
    """The cell's configuration, traffic and limits, its reviews cut to
    SMALL and its fit to 2 x 3 rounds, through run.run on the CPU."""
    from perfbench import run

    traffic = dict(CELL.traffic, outer_iters=2, rounds=3, track_every=2)
    cell = spec.Cell("mds.fit", 1, dict(CELL.config, params=SMALL), traffic, CELL.limits,
                     CELL.end_to_end, CELL.per_layer)
    res = run.run(cell, seed, 0.2, False, device="cpu", log=open(os.devnull, "w"))
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(CELL.limits)


WIDE = dict(m=22, d=10000, H=14528, B=64)
CANNED = dict(
    shapes=WIDE,
    counters=dict(fits_profiled=1, rounds_profiled=2),
    kernels=[("void sdca::gram_kernel<64>(float const*)", 0.0, 13000.0),
             ("void sdca::chain_stream_kernel<64, 0>(float const*)", 13000.0, 22000.0),
             ("void sdca::gram_kernel<64>(float const*)", 22000.0, 35000.0),
             ("void sdca::chain_stream_kernel<64, 0>(float const*)", 35000.0, 44000.0),
             ("ampere_sgemm_32x32", 44000.0, 44100.0)],
)


def test_wide_and_stream_readers_on_a_canned_record():
    m, d, H, B = WIDE["m"], WIDE["d"], WIDE["H"], WIDE["B"]
    # K1's least time at this width: the bytes of m H rows of 4 d + 12 and w, r
    least = (m * H * (4 * d + 12) + 8 * m * d) / peaks.HBM_BYTES_PER_S
    assert spec.reader("sdca_wide_roofline")(CANNED) == pytest.approx(100 * least / 22e-3)
    # the streaming kernel's own: rows once, the scratch once, r once
    stream = (m * H * 4 * d + m * (H // B) * (B * B + 4 * B) * 4 + 4 * m * d) / 3.35e12
    assert spec.reader("sdca_stream_roofline")(CANNED) == pytest.approx(100 * stream / 9e-3)
    assert stream > 4 * m * H * d / 67e12  # bound by bytes at this width


def test_readers_read_nothing_where_no_such_kernel_ran():
    chain = dict(CANNED, kernels=[("void sdca::gram_kernel<64>(float const*)", 0.0, 400.0),
                                  ("void sdca::chain_kernel<64, 0>(float const*)", 400.0, 1400.0)])
    assert spec.reader("sdca_stream_roofline")(chain) is None
    assert spec.reader("sdca_wide_roofline")(chain) is not None
    none = dict(CANNED, kernels=[("ampere_sgemm_32x32", 0.0, 10.0)])
    assert spec.reader("sdca_wide_roofline")(none) is None
    assert spec.reader("sdca_stream_roofline")(none) is None

