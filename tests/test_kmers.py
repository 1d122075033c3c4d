import numpy as np
import jax.numpy as jnp
import pytest

from gappadder import dna
from gappadder.ops import kmers


def _pack_np(s: str, k: int) -> tuple:
    """Oracle: big-endian 2-bit pack into ceil(k/16) uint32 limbs."""
    nl = (k + 15) // 16
    limbs = [0] * nl
    codes = dna.encode(s)
    for i, c in enumerate(codes[:k]):
        l, j = divmod(i, 16)
        limbs[l] |= int(c) << (30 - 2 * j)
    return tuple(limbs)


def _canon_np(s: str) -> str:
    rc = dna.decode(dna.revcomp(dna.encode(s)))
    return min(s, rc)


def test_extract_simple():
    s = "ACGTACGT"
    seq = dna.encode(s)[None, :]
    limbs, valid = kmers.extract_kmers(jnp.asarray(seq),
                                       jnp.asarray([8], jnp.int32), k=4)
    limbs, valid = np.asarray(limbs), np.asarray(valid)
    assert valid.all()
    for p in range(5):
        assert tuple(limbs[0, p]) == _pack_np(s[p:p + 4], 4)


def test_extract_n_invalidates():
    s = "ACGNACGT"
    seq = dna.encode(s)[None, :]
    limbs, valid = kmers.extract_kmers(jnp.asarray(seq),
                                       jnp.asarray([8], jnp.int32), k=4)
    valid = np.asarray(valid)
    # windows covering position 3 (N) invalid: p in 0..3
    assert list(valid[0]) == [False, False, False, False, True]
    assert (np.asarray(limbs)[0, 0] == 0xFFFFFFFF).all()


def test_extract_length_limit():
    s = "ACGTACGT"
    seq = dna.encode(s)[None, :]
    _, valid = kmers.extract_kmers(jnp.asarray(seq),
                                   jnp.asarray([6], jnp.int32), k=4)
    assert list(np.asarray(valid)[0]) == [True, True, True, False, False]


@pytest.mark.parametrize("k", [4, 16, 17, 31, 33])
def test_multilimb_pack_and_revcomp(rng, k):
    n = 3
    L = k + 10
    seqs = ["".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
            for _ in range(n)]
    seq = np.stack([dna.encode(s) for s in seqs])
    limbs, valid = kmers.extract_kmers(jnp.asarray(seq),
                                       jnp.full(n, L, jnp.int32), k)
    assert np.asarray(valid).all()
    limbs_np = np.asarray(limbs)
    for i, s in enumerate(seqs):
        for p in range(L - k + 1):
            assert tuple(limbs_np[i, p]) == _pack_np(s[p:p + k], k)
    rc = np.asarray(kmers.revcomp_kmers(limbs, k))
    for i, s in enumerate(seqs):
        for p in range(L - k + 1):
            want = dna.decode(dna.revcomp(dna.encode(s[p:p + k])))
            assert tuple(rc[i, p]) == _pack_np(want, k)


@pytest.mark.parametrize("k", [5, 21])
def test_count_distinct_matches_python(rng, k):
    L = 64
    B = 4
    seq = np.zeros((B, L), np.int8)
    lens = np.zeros(B, np.int32)
    truth = []
    for b in range(B):
        ln = int(rng.integers(k, L + 1))
        s = "".join(np.array(list("ACGTN"))[rng.integers(0, 5, ln)])
        seq[b, :ln] = dna.encode(s)
        lens[b] = ln
        cnt: dict[str, int] = {}
        for p in range(ln - k + 1):
            sub = s[p:p + k]
            if "N" in sub:
                continue
            c = _canon_np(sub)
            cnt[c] = cnt.get(c, 0) + 1
        truth.append(cnt)
    km, counts, nd = kmers.count_distinct(jnp.asarray(seq),
                                          jnp.asarray(lens), k)
    km, counts, nd = map(np.asarray, (km, counts, nd))
    for b in range(B):
        assert nd[b] == len(truth[b])
        got = {}
        for i in range(nd[b]):
            got[tuple(km[b, i])] = counts[b, i]
        want = {_pack_np(s, k): c for s, c in truth[b].items()}
        assert got == want
