import numpy as np
import jax.numpy as jnp
import pytest

from gappadder.ops import sw_host, sw_xla
from gappadder.ops.sw_host import SWParams


def _rand_pairs(rng, B, Lq, Lt, related=True):
    qs, ts, qlens, tlens = [], [], [], []
    for _ in range(B):
        ql = int(rng.integers(1, Lq + 1))
        tl = int(rng.integers(1, Lt + 1))
        q = rng.integers(0, 4, ql)
        if related and tl >= ql // 2 and ql >= 4:
            # make target contain a mutated chunk of query
            t = rng.integers(0, 4, tl)
            k = min(ql, tl) // 2
            off = int(rng.integers(0, tl - k + 1))
            chunk = q[:k].copy()
            muts = rng.random(k) < 0.1
            chunk[muts] = rng.integers(0, 4, muts.sum())
            t[off: off + k] = chunk
        else:
            t = rng.integers(0, 4, tl)
        qs.append(q); ts.append(t); qlens.append(ql); tlens.append(tl)
    qpad = np.zeros((B, Lq), np.int8)
    tpad = np.zeros((B, Lt), np.int8)
    for i, (q, t) in enumerate(zip(qs, ts)):
        qpad[i, :len(q)] = q
        tpad[i, :len(t)] = t
    return (qpad, np.array(qlens, np.int32), tpad, np.array(tlens, np.int32),
            qs, ts)


@pytest.mark.parametrize("mode", ["local", "overlap", "extend"])
@pytest.mark.parametrize("params", [SWParams(), SWParams(2, -3, 5, 2)])
def test_sw_xla_matches_oracle(rng, mode, params):
    B, Lq, Lt = 16, 24, 32
    qpad, qlen, tpad, tlen, qs, ts = _rand_pairs(rng, B, Lq, Lt)
    score, qend, tend = sw_xla.sw_batch(
        jnp.asarray(qpad), jnp.asarray(qlen), jnp.asarray(tpad),
        jnp.asarray(tlen), params, mode)
    score, qend, tend = map(np.asarray, (score, qend, tend))
    for b in range(B):
        want, _, _, H = sw_host.sw_np(qs[b], ts[b], params, mode)
        assert score[b] == want, (b, mode, score[b], want)
        # endpoint must achieve the best score
        assert H[qend[b], tend[b]] == want, (b, mode)
        if mode == "overlap" and want > 0:
            assert qend[b] == len(qs[b]) or tend[b] == len(ts[b])


def test_sw_simple_exact_match():
    q = np.array([0, 1, 2, 3], np.int8)
    s, qe, te = sw_xla.sw_batch(
        jnp.asarray(q[None]), jnp.asarray([4], jnp.int32),
        jnp.asarray(q[None]), jnp.asarray([4], jnp.int32))
    assert int(s[0]) == 4 and int(qe[0]) == 4 and int(te[0]) == 4


def test_sw_overlap_suffix_prefix():
    # q suffix TTAC overlaps t prefix TTAC
    q = np.array([0, 0, 3, 3, 0, 1], np.int8)  # AATTAC
    t = np.array([3, 3, 0, 1, 2, 2], np.int8)  # TTACGG
    s, qe, te = sw_xla.sw_batch(
        jnp.asarray(q[None]), jnp.asarray([6], jnp.int32),
        jnp.asarray(t[None]), jnp.asarray([6], jnp.int32),
        SWParams(), "overlap")
    assert int(s[0]) == 4
    assert int(qe[0]) == 6 and int(te[0]) == 4  # ends at q end, consumed TTAC of t


def test_sw_n_never_matches():
    q = np.array([4, 4, 4, 4], np.int8)
    s, _, _ = sw_xla.sw_batch(
        jnp.asarray(q[None]), jnp.asarray([4], jnp.int32),
        jnp.asarray(q[None]), jnp.asarray([4], jnp.int32))
    assert int(s[0]) == 0  # local alignment of all-N = empty


@pytest.mark.parametrize("params", [SWParams(), SWParams(1, -4, 7, 1)])
def test_sw_fit_mode_matches_oracle(rng, params):
    B, Lq, Lt = 10, 24, 40
    qpad, qlen, tpad, tlen, qs, ts = _rand_pairs(rng, B, Lq, Lt)
    score, qend, tend = sw_xla.sw_batch(
        jnp.asarray(qpad), jnp.asarray(qlen), jnp.asarray(tpad),
        jnp.asarray(tlen), params, "fit")
    score, qend, tend = map(np.asarray, (score, qend, tend))
    for b in range(B):
        want, _, _, H = sw_host.sw_np(qs[b], ts[b], params, "fit")
        assert score[b] == want, (b, score[b], want)
        assert qend[b] == len(qs[b])       # query fully consumed
        assert H[qend[b], tend[b]] == want


def test_sw_fit_full_query_with_clipped_local():
    # target contains the query except its last 3 bases mismatch:
    # local trims them; fit must keep the whole query aligned
    q = dna_codes("ACGTACGTACGTTTT")
    t = dna_codes("GGACGTACGTACGAAAGG")
    p = SWParams(1, -1, 2, 1)
    s_loc, qe_loc, _ = sw_xla.sw_batch(
        jnp.asarray(q[None]), jnp.asarray([len(q)], jnp.int32),
        jnp.asarray(t[None]), jnp.asarray([len(t)], jnp.int32), p, "local")
    s_fit, qe_fit, _ = sw_xla.sw_batch(
        jnp.asarray(q[None]), jnp.asarray([len(q)], jnp.int32),
        jnp.asarray(t[None]), jnp.asarray([len(t)], jnp.int32), p, "fit")
    assert int(qe_loc[0]) < len(q)          # local clipped the tail
    assert int(qe_fit[0]) == len(q)         # fit consumed it


def dna_codes(s):
    from gappadder import dna
    return dna.encode(s)


def test_traceback_cigar():
    q = np.array([0, 1, 2, 3, 0, 1], np.int8)
    t = np.array([0, 1, 3, 0, 1], np.int8)  # deletion of G relative to q
    p = SWParams(1, -2, 2, 1)
    score, qend, tend, _ = sw_host.sw_np(q, t, p, "local")
    qs, ts_, cigar = sw_host.traceback(q, t, p, "local", qend, tend)
    # reconstruct: alignment must consume (qend-qs) of q and (tend-ts) of t
    qc = sum(n for op, n in cigar if op in "MI")
    tc = sum(n for op, n in cigar if op in "MD")
    assert qc == qend - qs and tc == tend - ts_
    assert score == 6 - 2 or score > 0


# (B, Lq, Lt): queries longer and shorter than their targets
ORACLE_SHAPES = [(24, 72, 56), (16, 24, 48)]


@pytest.mark.parametrize("shape", ORACLE_SHAPES, ids=["long_q", "short_q"])
@pytest.mark.parametrize("mode", ["local", "overlap", "fit", "extend"])
def test_sw_xla_n_codes_and_slack_match_oracle(rng, mode, shape):
    """sw_xla against the host DP in all four modes, with N codes
    sprinkled into both sequences and, in overlap mode, an end slack."""
    B, Lq, Lt = shape
    params = SWParams(1, -4, 7, 1)
    qpad, qlen, tpad, tlen, _, _ = _rand_pairs(rng, B, Lq, Lt)
    qpad[rng.random(qpad.shape) < 0.03] = 4
    tpad[rng.random(tpad.shape) < 0.03] = 4
    slack = 3 if mode == "overlap" else 0
    score, qend, tend = map(np.asarray, sw_xla.sw_batch(
        jnp.asarray(qpad), jnp.asarray(qlen), jnp.asarray(tpad),
        jnp.asarray(tlen), params, mode, end_slack=slack))
    for b in range(B):
        want, _, _, H = sw_host.sw_np(qpad[b, :qlen[b]], tpad[b, :tlen[b]],
                                      params, mode, end_slack=slack)
        assert score[b] == want, (b, mode, score[b], want)
        assert H[qend[b], tend[b]] == want, (b, mode)
