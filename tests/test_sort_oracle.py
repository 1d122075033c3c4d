"""The pipeline's variadic multi-limb sorts against numpy lexsort."""

import numpy as np
import jax.numpy as jnp
import pytest

from gappadder.ops import kmers
from gappadder.pipeline import assemble

FULL = 0xFFFFFFFF


def _lex_order(limbs):
    """Row order of [P, nl] keys, first limb most significant."""
    return np.lexsort(tuple(limbs[:, l] for l in range(limbs.shape[1] - 1,
                                                       -1, -1)))


def _merge_oracle(acc, acc_cnt, new, new_cnt, M):
    """Distinct non-FULL keys of acc + new, sorted, counts summed, cut
    to M rows, FULL / 0 padded."""
    nl = acc.shape[-1]
    out_k = np.full((acc.shape[0], M, nl), FULL, np.uint32)
    out_c = np.zeros((acc.shape[0], M), np.int64)
    for g in range(acc.shape[0]):
        tot: dict[tuple, int] = {}
        for keys, cnts in ((acc[g], acc_cnt[g]), (new[g], new_cnt[g])):
            for key, c in zip(map(tuple, keys), cnts):
                if all(v == FULL for v in key):
                    continue
                tot[key] = tot.get(key, 0) + int(c)
        ordered = sorted(tot)[:M]
        for i, key in enumerate(ordered):
            out_k[g, i] = key
            out_c[g, i] = tot[key]
    return out_k, out_c


def _keys(rng, shape, nl, lo=0, hi=1 << 32, full_frac=0.0):
    k = rng.integers(lo, hi, shape + (nl,), dtype=np.uint64).astype(
        np.uint32)
    if full_frac:
        k[rng.random(shape) < full_frac] = FULL
    return k


CASES = {
    # sort_kmers: limbs, ties, full-range unsigned limbs, FULL rows last,
    # signed payloads carried with their keys
    "sort_1limb_ties": ("sort", 1, dict(hi=40)),
    "sort_2limb_payload": ("sort", 2, dict(hi=6, payload=True)),
    "sort_4limb_fullrange": ("sort", 4, dict(full_frac=0.1)),
    "sort_3limb_signed_payload": ("sort", 3, dict(hi=3, payload=True,
                                                  signed=True)),
    # the k-mer table merge: counted and countless, with truncation
    "merge_counted_2limb": ("merge", 2, dict(hi=20, M=64)),
    "merge_counted_1limb_truncates": ("merge", 1, dict(hi=1000, M=16)),
    "merge_nocount_3limb": ("nocnt", 3, dict(hi=8, M=64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sort_matches_lexsort_oracle(case):
    kind, nl, kw = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    G, P = 3, 300
    if kind == "sort":
        keys = _keys(rng, (G, P), nl, hi=kw.get("hi", 1 << 32),
                     full_frac=kw.get("full_frac", 0.0))
        extra = None
        if kw.get("payload"):
            lo = -(1 << 30) if kw.get("signed") else 0
            pay = rng.integers(lo, 1 << 30, (G, P)).astype(np.int32)
            extra = [jnp.asarray(pay)]
        s, ex = kmers.sort_kmers(jnp.asarray(keys), extra)
        s = np.asarray(s)
        for g in range(G):
            order = _lex_order(keys[g])
            np.testing.assert_array_equal(s[g], keys[g][order])
            if extra is not None:
                got = sorted(zip(map(tuple, s[g]), np.asarray(ex[0])[g]))
                want = sorted(zip(map(tuple, keys[g]), pay[g]))
                assert got == want
        return
    M = kw["M"]
    acc = np.full((G, M, nl), FULL, np.uint32)
    acc_cnt = np.zeros((G, M), np.int32)
    for g in range(G):         # a sorted-unique accumulator, FULL padded
        u = np.unique(_keys(rng, (M // 2,), nl, hi=kw["hi"]), axis=0)
        acc[g, :len(u)] = u
        acc_cnt[g, :len(u)] = rng.integers(1, 5, len(u))
    new = _keys(rng, (G, P), nl, hi=kw["hi"], full_frac=0.2)
    new_cnt = np.where((new == FULL).all(-1), 0, 1).astype(np.int32)
    want_k, want_c = _merge_oracle(acc, acc_cnt, new, new_cnt, M)
    if kind == "merge":
        got_k, got_c = assemble._merge_chunk_impl(
            jnp.asarray(acc), jnp.asarray(acc_cnt), jnp.asarray(new),
            jnp.asarray(new_cnt))
        np.testing.assert_array_equal(np.asarray(got_c), want_c)
    else:
        got_k = assemble._merge_chunk_nocnt_impl(jnp.asarray(acc),
                                                 jnp.asarray(new))
    np.testing.assert_array_equal(np.asarray(got_k), want_k)
