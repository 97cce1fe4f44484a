"""The port's plane shuffle join (ops/meshshuffle.MeshShuffleJoinKernel)
against the JAX package's, on the reference's 8-device CPU mesh and the
port's 8-shard CPU plane (and on 1-shard planes, where both delegate to
their single-device matcher).

The same seeded key lanes (two keys, NULLs on both sides) give the same
(probe, build) pair sets; a build-side skew overflows the send buckets,
so the bucket retry runs in both; with the retry budget spent,
`ShuffleOverflowError` fires in both.
"""

import numpy as np
import pytest
import torch

from tidb_tpu.devplane import build_mesh as j_build_mesh
from tidb_tpu.ops import meshshuffle as js
from tidb_tpu_torch import devplane
from tidb_tpu_torch.ops import meshshuffle as ps

torch.set_num_threads(1)


def lanes(*cols):
    return [(np.asarray(d), np.asarray(v, dtype=bool)) for d, v in cols]


def pairs(kernel, pk, bk):
    li, ri = kernel(pk, bk, len(bk[0][0]), len(pk[0][0]))
    return sorted(zip(li.tolist(), ri.tolist()))


@pytest.mark.parametrize("ndev", [8, 1])
@pytest.mark.parametrize("skew", [0.0, 0.8])
def test_shuffle_pairs_match_reference(ndev, skew):
    """skew 0.8 sends most build rows to one destination shard, ~6,550
    of each shard's 8,192 past its 4,096-row bucket: the bucket retry
    runs in both packages."""
    rng = np.random.default_rng(11)
    n, m = 1500, 65536 if skew else 8192
    p = rng.integers(0, 300, n)
    b = np.where(rng.random(m) < skew, 7, rng.integers(0, 300, m))
    pk = lanes((p, rng.random(n) > 0.05),
               (rng.integers(0, 2, n), np.ones(n)))
    bk = lanes((b, rng.random(m) > 0.05),
               (rng.integers(0, 2, m), np.ones(m)))
    want = pairs(js.MeshShuffleJoinKernel(j_build_mesh(ndev), 2), pk, bk)
    got = pairs(ps.MeshShuffleJoinKernel(
        devplane.build_mesh(ndev, device="cpu"), 2), pk, bk)
    assert got == want and want


def test_shuffle_overflow_error_in_both(monkeypatch):
    """With no retries left a skewed bucket raises in both packages."""
    rng = np.random.default_rng(12)
    n = 1200
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 300, n))
    pk = bk = lanes((keys, np.ones(n)))
    for mod, kern in ((js, js.MeshShuffleJoinKernel(j_build_mesh(8), 1)),
                      (ps, ps.MeshShuffleJoinKernel(
                          devplane.build_mesh(8, device="cpu"), 1))):
        monkeypatch.setattr(mod, "range", lambda _n: iter(()),
                            raising=False)
        with pytest.raises(mod.ShuffleOverflowError):
            kern(pk, bk, n, n)
