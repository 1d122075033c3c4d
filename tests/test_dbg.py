import numpy as np
import jax.numpy as jnp
import pytest

from gappadder import dna
from gappadder.ops import dbg, kmers


def _kstrings_of(seq: str, k: int):
    """Distinct canonical k-mers of seq, as the reference KMC stage
    would produce (kmc default counts canonical forms)."""
    seen = set()
    out = []
    for p in range(len(seq) - k + 1):
        s = seq[p:p + k]
        if "N" in s:
            continue
        rc = dna.decode(dna.revcomp(dna.encode(s)))
        c = min(s, rc)
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def _run(seqs_kstr, k, sub_k, **kw):
    M = max(len(seqs_kstr), 1)
    arr = np.full((1, M, k), dna.N, np.int8)
    for i, s in enumerate(seqs_kstr):
        arr[0, i] = dna.encode(s)
    out, lens, cnt = dbg.assemble_unitigs(
        jnp.asarray(arr), jnp.asarray([len(seqs_kstr)], jnp.int32),
        k=k, sub_k=sub_k, **kw)
    out, lens, cnt = np.asarray(out[0]), np.asarray(lens[0]), int(cnt[0])
    return [dna.decode(out[i][:lens[i]]) for i in range(cnt)]


def _canon(s):
    rc = dna.decode(dna.revcomp(dna.encode(s)))
    return min(s, rc)


def test_single_path_reconstruction(rng):
    # a random 60bp sequence with unique k-1 overlaps assembles back
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60)])
    k, sub_k = 21, 15
    ks = _kstrings_of(truth, k)
    unitigs = _run(ks, k, sub_k, max_unitigs=8, max_len=128, min_len=40)
    assert len(unitigs) >= 1
    # the longest unitig should be the full truth (canonical strand)
    best = max(unitigs, key=len)
    assert _canon(best) == _canon(truth) or truth in best or \
        dna.decode(dna.revcomp(dna.encode(truth))) in best, (best, truth)


def test_min_len_filter(rng):
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)])
    k, sub_k = 21, 15
    ks = _kstrings_of(truth, k)
    unitigs = _run(ks, k, sub_k, max_unitigs=8, max_len=128, min_len=40)
    assert all(len(u) >= 40 for u in unitigs)
    unitigs2 = _run(ks, k, sub_k, max_unitigs=8, max_len=128, min_len=10)
    assert any(_canon(u) == _canon(truth) for u in unitigs2)


def test_branching_splits_unitigs(rng):
    # two sequences sharing a middle segment -> branch point splits chains
    mid = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)])
    a = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)]) + mid
    b = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)]) + mid
    k, sub_k = 21, 15
    ks = sorted(set(_kstrings_of(a, k)) | set(_kstrings_of(b, k)))
    unitigs = _run(ks, k, sub_k, max_unitigs=16, max_len=128, min_len=10)
    # mid segment must appear in some unitig, and no unitig contains both
    # full a and full b
    assert any(_canon(mid[-15:]) in (u + "|" + _canon(u)) or mid[-15:] in u
               or dna.decode(dna.revcomp(dna.encode(mid[-15:]))) in u
               for u in unitigs)
    assert not any(a in u and b in u for u in unitigs)


def test_cycle_handling():
    # perfectly periodic sequence -> DBG cycle; must not hang and must
    # emit something deterministic
    period = "ACGTTGCAGT"
    truth = period * 8
    k, sub_k = 21, 15
    ks = _kstrings_of(truth, k)
    unitigs = _run(ks, k, sub_k, max_unitigs=8, max_len=256, min_len=10)
    assert len(unitigs) >= 1  # cycle broken and emitted


def test_empty_input():
    unitigs = _run([], 21, 15, max_unitigs=4, max_len=64, min_len=40)
    assert unitigs == []


def test_batched_matches_single(rng):
    k, sub_k = 17, 11
    truths = ["".join(np.array(list("ACGT"))[rng.integers(0, 4, 50)])
              for _ in range(3)]
    kss = [_kstrings_of(t, k) for t in truths]
    M = max(len(ks) for ks in kss)
    arr = np.full((3, M, k), dna.N, np.int8)
    cnt = np.zeros(3, np.int32)
    for g, ks in enumerate(kss):
        cnt[g] = len(ks)
        for i, s in enumerate(ks):
            arr[g, i] = dna.encode(s)
    out, lens, n = dbg.assemble_unitigs(
        jnp.asarray(arr), jnp.asarray(cnt), k=k, sub_k=sub_k,
        max_unitigs=8, max_len=128, min_len=10)
    for g in range(3):
        single = _run(kss[g], k, sub_k, max_unitigs=8, max_len=128, min_len=10)
        got = [dna.decode(np.asarray(out[g][i][:int(lens[g][i])]))
               for i in range(int(n[g]))]
        assert got == single


# ---- bubble popping (coverage-guided tour-bus equivalent) ----------------

def _run_cov(seqs_kstr, counts, k, sub_k, **kw):
    M = max(len(seqs_kstr), 1)
    arr = np.full((1, M, k), dna.N, np.int8)
    cnt = np.zeros((1, M), np.int32)
    for i, s in enumerate(seqs_kstr):
        arr[0, i] = dna.encode(s)
        cnt[0, i] = counts[i]
    out, lens, n = dbg.assemble_unitigs(
        jnp.asarray(arr), jnp.asarray([len(seqs_kstr)], jnp.int32),
        jnp.asarray(cnt), k=k, sub_k=sub_k, **kw)
    out, lens, n = np.asarray(out[0]), np.asarray(lens[0]), int(n[0])
    return [dna.decode(out[i][:lens[i]]) for i in range(n)]


def _snp_bubble_input(rng, k=21, sub_k=15, L=150, pos=75,
                      cov_true=8, cov_err=1):
    """Distinct k-mers of a truth sequence (count cov_true) plus the
    extra k-mers of a single-SNP error variant (count cov_err)."""
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[truth[pos]]
    err = truth[:pos] + alt + truth[pos + 1:]
    ks_t = _kstrings_of(truth, k)
    ks_e = [s for s in _kstrings_of(err, k) if s not in set(ks_t)]
    ks = ks_t + ks_e
    counts = [cov_true] * len(ks_t) + [cov_err] * len(ks_e)
    return truth, err, ks, counts


def test_bubble_pop_snp(rng):
    k, sub_k = 21, 15
    truth, _, ks, counts = _snp_bubble_input(rng, k, sub_k)
    kw = dict(max_unitigs=16, max_len=256, min_len=10)
    # without popping the SNP bubble breaks the chain: nothing spans truth
    plain = _run_cov(ks, counts, k, sub_k, pop_bubbles=0, **kw)
    assert not any(_canon(u) == _canon(truth) for u in plain)
    # one pop round deletes the low-coverage branch; chains fuse
    popped = _run_cov(ks, counts, k, sub_k, pop_bubbles=1, **kw)
    assert any(_canon(u) == _canon(truth) for u in popped), popped


def test_bubble_pop_keeps_high_coverage_branch(rng):
    # coverage reversed: the "error" variant is the high-coverage path
    k, sub_k = 21, 15
    truth, err, ks, _ = _snp_bubble_input(rng, k, sub_k)
    n_t = len(_kstrings_of(truth, k))
    counts = [1] * n_t + [8] * (len(ks) - n_t)
    popped = _run_cov(ks, counts, k, sub_k, pop_bubbles=1,
                      max_unitigs=16, max_len=256, min_len=10)
    assert any(_canon(u) == _canon(err) for u in popped), popped
    assert not any(_canon(u) == _canon(truth) for u in popped)


def test_bubble_pop_noop_on_clean_graph(rng):
    # bubble-free input: popping must change nothing
    k, sub_k = 21, 15
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 120)])
    ks = _kstrings_of(truth, k)
    kw = dict(max_unitigs=8, max_len=256, min_len=10)
    a = _run(ks, k, sub_k, pop_bubbles=0, **kw)
    b = _run_cov(ks, [5] * len(ks), k, sub_k, pop_bubbles=2, **kw)
    assert a == b


def test_bubble_pop_leaves_long_divergence(rng):
    # two sequences sharing prefix+suffix but diverging over a LONG
    # middle (longer than max_bubble_len): both branches must survive
    k, sub_k = 21, 15
    pre = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40)])
    suf = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40)])
    mid_a = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60)])
    mid_b = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60)])
    a, b = pre + mid_a + suf, pre + mid_b + suf
    ks_a = _kstrings_of(a, k)
    ks_b = [s for s in _kstrings_of(b, k) if s not in set(ks_a)]
    ks = ks_a + ks_b
    counts = [8] * len(ks_a) + [1] * len(ks_b)
    plain = _run_cov(ks, counts, k, sub_k, pop_bubbles=0,
                     max_unitigs=32, max_len=512, min_len=10)
    popped = _run_cov(ks, counts, k, sub_k, pop_bubbles=2,
                      max_unitigs=32, max_len=512, min_len=10)
    assert sorted(popped) == sorted(plain)


def test_bubble_pop_batch_wiring(rng):
    # pipeline wiring: noisy reads + ci0 + bubble popping recovers the
    # full truth contig (the tour-bus path instead of the adaptive filter)
    from gappadder.config import Config
    from gappadder.pipeline import assemble

    k, sub_k = 21, 15
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 150)])
    pos, base = 75, "T"
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[truth[pos]]
    err = truth[:pos] + alt + truth[pos + 1:]
    reads = []
    for s in range(0, 150 - 50 + 1, 5):        # clean 50bp tiling x5
        reads += [truth[s:s + 50]] * 5
    reads.append(err[pos - 25:pos + 25])        # one error read
    R, L = len(reads), 50
    arr = np.full((1, R, L), dna.N, np.int8)
    for i, r in enumerate(reads):
        arr[0, i, :len(r)] = dna.encode(r)
    rlen = np.full((1, R), L, np.int32)
    nr = np.array([R], np.int32)

    cfg = Config(draft_genome="x", kmers=((k, sub_k),), min_kmer_count=0,
                 min_contig_len=40, bubble_pop_rounds=2,
                 max_unitigs=16, max_contig_len=512)
    gc = assemble.assemble_gap_batch(cfg, arr, rlen, nr,
                                     max_distinct=1 << 11)
    got = [dna.decode(gc.seq[0, i, :gc.length[0, i]])
           for i in range(int(gc.count[0]))]
    assert any(_canon(u) == _canon(truth) for u in got), got
