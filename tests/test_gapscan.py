import numpy as np
import jax.numpy as jnp

from gappadder import dna
from gappadder.io import fasta
from gappadder.ops import gapscan


def _genome_from_strs(seqs):
    import tempfile, os
    fd, path = tempfile.mkstemp(suffix=".fa")
    os.close(fd)
    fasta.write_fasta(path, [(f"scaf{i}", s) for i, s in enumerate(seqs)])
    g = fasta.read_fasta(path)
    os.unlink(path)
    return g


def _reference_scan(seqs, min_gap):
    """Oracle reimplementation of gnrt_gap_positions semantics."""
    out = []
    for si, s in enumerate(seqs):
        i = 0
        num = 0
        while i < len(s):
            if s[i] not in "ACGT":
                j = i
                while j < len(s) and s[j] not in "ACGT":
                    j += 1
                if j < len(s) and (j - i) >= min_gap and s[i] == "N":
                    num += 1
                    out.append((si, i, j, num))
                i = j + 1
            else:
                i += 1
    return out


def test_simple_gap():
    g = _genome_from_strs(["ACGT" + "N" * 10 + "ACGT"])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    assert len(gaps["start"]) == 1
    assert gaps["local_start"][0] == 4
    assert gaps["local_end"][0] == 14
    assert gaps["number"][0] == 1


def test_min_gap_filter():
    g = _genome_from_strs(["ACGTNNNACGT" + "N" * 8 + "ACGT"])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    assert len(gaps["start"]) == 1
    assert gaps["local_start"][0] == 11


def test_trailing_gap_dropped():
    # reference drops an N-run with no ACGT after it in the scaffold
    g = _genome_from_strs(["ACGT" + "N" * 10])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    assert len(gaps["start"]) == 0


def test_gap_not_bridging_scaffolds():
    # scaffold1 ends with Ns, scaffold2 starts with Ns: two separate runs,
    # first one trailing (dropped), second kept.
    g = _genome_from_strs(["ACGT" + "N" * 6, "N" * 6 + "ACGT"])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    assert len(gaps["start"]) == 1
    assert gaps["scaffold"][0] == 1
    assert gaps["local_start"][0] == 0


def test_multi_scaffold_numbering():
    g = _genome_from_strs([
        "ACGTACGT" + "N" * 5 + "ACGT" + "N" * 7 + "ACGTACGT",
        "TTTT" + "N" * 5 + "GGGG",
    ])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    assert len(gaps["start"]) == 3
    assert list(gaps["scaffold"]) == [0, 0, 1]
    assert list(gaps["number"]) == [1, 2, 1]


def test_random_vs_oracle(rng):
    bases = np.array(list("ACGTN"))
    seqs = []
    for _ in range(5):
        n = int(rng.integers(50, 400))
        probs = [0.2, 0.2, 0.2, 0.2, 0.2]
        seqs.append("".join(rng.choice(bases, size=n, p=probs)))
    g = _genome_from_strs(seqs)
    for min_gap in (1, 2, 5):
        gaps = gapscan.scan_genome_np(g, min_gap_size=min_gap)
        got = list(zip(gaps["scaffold"], gaps["local_start"],
                       gaps["local_end"], gaps["number"]))
        want = [(s, a, b, n) for s, a, b, n in _reference_scan(seqs, min_gap)]
        assert [(int(a), int(b), int(c), int(d)) for a, b, c, d in got] == want


def test_extract_flanks_matches_reference_slices():
    scaf = "ACGTACGTACGTACGTACGT" + "N" * 10 + "TGCATGCATGCATGCATGCA"
    g = _genome_from_strs([scaf])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    flank_len, margin = 12, 5
    left, right, ll, rl = gapscan.extract_flanks(
        jnp.asarray(g.seq),
        jnp.asarray(gaps["start"], jnp.int32), jnp.asarray(gaps["end"], jnp.int32),
        jnp.asarray(g.offsets[gaps["scaffold"]], jnp.int32),
        jnp.asarray(g.offsets[gaps["scaffold"]] + g.lengths[gaps["scaffold"]], jnp.int32),
        flank_len=flank_len, margin=margin)
    s, e = int(gaps["local_start"][0]), int(gaps["local_end"][0])
    # reference: seq[start-frame : start-5] and seq[end+5 : end+frame]
    want_left = scaf[s - flank_len: s - margin]
    want_right = scaf[e + margin: e + flank_len]
    ll, rl = int(ll[0]), int(rl[0])
    assert dna.decode(np.asarray(left)[0][:ll]) == want_left
    assert dna.decode(np.asarray(right)[0][:rl]) == want_right


def test_extract_flanks_near_scaffold_edges():
    scaf = "ACGTACG" + "N" * 8 + "TGCATGC"  # start=7 < flank_len
    g = _genome_from_strs([scaf])
    gaps = gapscan.scan_genome_np(g, min_gap_size=5)
    left, right, ll, rl = gapscan.extract_flanks(
        jnp.asarray(g.seq),
        jnp.asarray(gaps["start"], jnp.int32), jnp.asarray(gaps["end"], jnp.int32),
        jnp.asarray(g.offsets[gaps["scaffold"]], jnp.int32),
        jnp.asarray(g.offsets[gaps["scaffold"]] + g.lengths[gaps["scaffold"]], jnp.int32),
        flank_len=300, margin=5)
    assert int(ll[0]) == 2  # seq[0:7-5]
    assert dna.decode(np.asarray(left)[0][:2]) == "AC"
    assert int(rl[0]) == 2  # seq[end+5 : min(end+300, scaf_end)]
    assert dna.decode(np.asarray(right)[0][:2]) == "GC"


def test_host_twins_match_device_kernels(rng):
    """find_gap_runs_host / extract_flanks_host are bit-equal to the
    jit kernels on randomized drafts (the pipeline picks the host path
    below HOST_SCAN_MAX, the device path above — same answers)."""
    import jax.numpy as jnp
    from gappadder import dna
    from gappadder.ops import gapscan

    for trial in range(5):
        L = int(rng.integers(500, 4000))
        seq = rng.integers(0, 4, L).astype(np.int8)
        # plant N runs of varying lengths, some trailing, plus SEPs
        for _ in range(int(rng.integers(1, 8))):
            a = int(rng.integers(0, L - 10))
            seq[a:a + int(rng.integers(1, 120))] = dna.N
        for _ in range(2):
            seq[int(rng.integers(0, L))] = dna.SEP
        seq[-int(rng.integers(1, 30)):] = dna.N      # trailing run

        hs, he = gapscan.find_gap_runs_host(seq, 20)
        ds, de, dc = gapscan.find_gap_runs(jnp.asarray(seq), 20, 64)
        n = int(dc)
        assert hs.tolist() == np.asarray(ds)[:n].tolist()
        assert he.tolist() == np.asarray(de)[:n].tolist()

        if n:
            sb = np.zeros(n, np.int64)
            se = np.full(n, L, np.int64)
            hf = gapscan.extract_flanks_host(seq, hs, he, sb, se,
                                             flank_len=100)
            df = gapscan.extract_flanks(
                jnp.asarray(seq), jnp.asarray(hs, jnp.int32),
                jnp.asarray(he, jnp.int32), jnp.asarray(sb, jnp.int32),
                jnp.asarray(se, jnp.int32), flank_len=100)
            for h, d in zip(hf, df):
                assert np.array_equal(np.asarray(h), np.asarray(d))
