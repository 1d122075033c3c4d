"""swutil: pads SW batches to shape buckets and unpads the results."""

import numpy as np
import pytest

from gappadder.ops import sw_host, swutil
from gappadder.ops.sw_host import BWA_PARAMS


@pytest.mark.parametrize("n,lo,want", [(1, 64, 64), (64, 64, 64),
                                         (65, 64, 128), (300, 32, 512)])
def test_bucket_rounds_up_to_a_power_of_two_floor(n, lo, want):
    assert swutil._bucket(n, lo) == want


def test_sw_pairs_pads_to_buckets_and_unpads(rng, monkeypatch):
    B, Lq, Lt = 5, 37, 90
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    seen = []
    real = swutil.sw_batch

    def spy(qa, qla, ta, tla, *a, **k):
        seen.append((qa.shape, ta.shape))
        return real(qa, qla, ta, tla, *a, **k)

    monkeypatch.setattr(swutil, "sw_batch", spy)
    s, qe, te = swutil.sw_pairs(q, ql, t, tl, BWA_PARAMS, "local")
    assert seen == [((swutil.B_FLOOR, 64), (swutil.B_FLOOR, 128))]
    assert s.shape == qe.shape == te.shape == (B,)
    for b in range(B):
        want, _, _, H = sw_host.sw_np(q[b, :ql[b]], t[b, :tl[b]],
                                      BWA_PARAMS, "local")
        assert s[b] == want and H[qe[b], te[b]] == want


def test_sw_ragged_groups_by_query_bucket(rng, monkeypatch):
    lens = [10, 40, 100, 12]
    qs = [rng.integers(0, 4, n).astype(np.int8) for n in lens]
    ts = [np.concatenate([rng.integers(0, 4, 5).astype(np.int8), q,
                          rng.integers(0, 4, 5).astype(np.int8)])
          for q in qs]
    calls = []
    real = swutil.sw_pairs

    def spy(qa, ql, ta, tl, *a, **k):
        calls.append(qa.shape[1])
        return real(qa, ql, ta, tl, *a, **k)

    monkeypatch.setattr(swutil, "sw_pairs", spy)
    s, qe, te = swutil.sw_ragged(qs, ts, BWA_PARAMS, "local")
    assert calls == [12, 40, 100]      # buckets 32, 64, 128 in order
    np.testing.assert_array_equal(s, lens)       # exact embedded copies
    np.testing.assert_array_equal(qe, lens)
    np.testing.assert_array_equal(te, [n + 5 for n in lens])
    z = swutil.sw_ragged([], [], BWA_PARAMS, "local")
    assert all(len(x) == 0 for x in z)
