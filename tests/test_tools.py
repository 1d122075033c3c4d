import numpy as np

from gappadder import dna
from gappadder.io import bam as bam_io, fasta
from gappadder.ops import coverage
from gappadder.tools import evaluate, refiner, scaffold


class FakeAln:
    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, np.asarray(v))


def test_coverage_with_cutoff():
    # two contigs, len 100 and 50; 3 qualifying reads on c0
    aln = FakeAln(tid=[0, 0, 0, 1, 0], nmatch=[50, 50, 100, 25, 10],
                  read_len=[50, 50, 100, 25, 100],
                  pos=[0, 50, 0, 0, 0], flag=[0] * 5, mapq=[60] * 5,
                  mtid=[-1] * 5, mpos=[0] * 5, tlen=[0] * 5,
                  lclip=[0] * 5, rclip=[0] * 5)
    cov = refiner.coverage_with_cutoff(aln, [100, 50], cutoff=0.99)
    assert cov[0] == (50 + 50 + 100) / 100  # read with M=10/100 excluded
    assert cov[1] == 0.5


def test_per_base_coverage():
    mean, covered = coverage.per_base_coverage(
        np.array([0, 0]), np.array([0, 50]), np.array([50, 50]), [100])
    assert mean[0] == 1.0 and covered[0] == 100
    mean, covered = coverage.per_base_coverage(
        np.array([0, 0]), np.array([0, 0]), np.array([50, 50]), [100])
    assert mean[0] == 1.0 and covered[0] == 50


def test_refine_by_reads():
    aln = FakeAln(tid=[0] * 4 + [1] * 4,
                  lclip=[0, 0, 0, 0, 20, 20, 20, 0],
                  rclip=[0] * 8,
                  nmatch=[100] * 8, read_len=[100] * 8)
    keep = refiner.refine_by_reads(aln, [500, 500], cf_cutoff=0.5)
    assert keep == [0]


def test_unique_names():
    assert refiner.unique_names(["a", "b", "a", "c"]) == [0, 1, 3]


def test_classify_repeat(rng):
    a = rng.integers(0, 4, 120).astype(np.int8)
    fwd, f, r = refiner.classify_repeat(a, a)
    assert fwd == "forward"
    rc, f, r = refiner.classify_repeat(a, dna.revcomp(a))
    assert rc == "reverse"
    other = rng.integers(0, 4, 120).astype(np.int8)
    none, f, r = refiner.classify_repeat(a, other)
    assert none == "none"


def test_linkage_and_scaffolding(rng):
    # contigs A, B adjacent on the true sequence, PE links span them
    truth = rng.integers(0, 4, 600).astype(np.int8)
    A, B = truth[:300].copy(), truth[310:].copy()
    # simulate 10 pairs linking A(tid 0) -> B(tid 1)
    aln = FakeAln(
        tid=[0] * 10, mtid=[1] * 10, pos=list(range(200, 250, 5)),
        mapq=[60] * 10, flag=[0x1 | 0x40 | 0x20] * 10,
        nmatch=[100] * 10, read_len=[100] * 10, lclip=[0] * 10,
        rclip=[0] * 10, mpos=[10] * 10, tlen=[0] * 10)
    links = refiner.cnt_contig_linkage(aln, [300, 290], ["A", "B"],
                                       insert_size=250, sd=20)
    assert len(links) == 1 and links[0][8] == 10
    # FR pair (fwd read, reverse mate): left '+' and right '+'
    assert links[0][3] == "+" and links[0][7] == "+"
    recs, used = scaffold.build_scaffolds([A, B], ["A", "B"], links)
    assert len(recs) == 1
    name, seq = recs[0]
    # reference header format lname$ori1$rname$ori2$dist
    # (scaffolding.cpp:281), N-joint of int(mean_dist)
    assert name.startswith("A$+$B$+$")
    assert len(seq) >= len(A) + len(B)
    assert used == {0, 1}


def test_true_gap_extraction_and_closure(tmp_path, rng):
    truth = rng.integers(0, 4, 1200).astype(np.int8)
    gs, ge = 500, 650
    finished = fasta.Genome(
        seq=truth, offsets=np.array([0]), lengths=np.array([len(truth)]),
        names=["fin0"])
    gaps = {"start": np.array([gs]), "end": np.array([ge]),
            "scaffold": np.array([0]), "number": np.array([1]),
            "local_start": np.array([gs]), "local_end": np.array([ge])}
    FL = 100
    flank_left = truth[gs - FL:gs - 5][None, :]
    flank_right = truth[ge + 5:ge + FL][None, :]
    lens = (np.array([FL - 5]), np.array([FL - 5]))
    truths = evaluate.extract_true_gap_seqs(gaps, finished, flank_left,
                                            flank_right, lens)
    assert 0 in truths
    np.testing.assert_array_equal(truths[0], truth[gs - 5:ge + 5])

    stats = evaluate.closure_stats({0: truth[gs - 5:ge + 5].copy()}, truths)
    assert stats["hit_list"] == [0]
    # a wrong fill is not counted
    bad = rng.integers(0, 4, 150).astype(np.int8)
    stats2 = evaluate.closure_stats({0: bad}, truths)
    assert stats2["hit_list"] == []


def test_exact_per_base_coverage_with_cigars(tmp_path, rng):
    """Exact M-segment pileup (Coverage.cpp:14-141): interior deletions
    must advance the target cursor — the nmatch-span approximation gets
    this wrong; retained CIGARs must get it right."""
    from gappadder.io import bam as bam_io
    from gappadder.ops import coverage as cov_ops
    refs = [("c0", 100)]
    # read: 10M5D10M at pos 0 -> covers [0,10) and [15,25)
    recs = [dict(name="r0", flag=0, tid=0, pos=0, mapq=60,
                 cigar=[("M", 10), ("D", 5), ("M", 10)],
                 mtid=-1, mpos=-1, tlen=0, seq="A" * 20)]
    p = str(tmp_path / "cov.bam")
    bam_io.write_bam(p, refs, recs)
    aln = bam_io.read_bam(p, keep_cigars=True)
    assert aln.cig_off is not None and aln.cig_off[-1] == 3

    mean_ex, cov_ex = cov_ops.per_base_coverage(
        aln.tid, aln.pos, aln.nmatch, [100],
        cigars=(aln.cig_op, aln.cig_ln, aln.cig_off))
    assert cov_ex[0] == 20            # 10 + 10, deletion gap NOT covered
    assert abs(mean_ex[0] - 20 / 100) < 1e-12

    mean_ap, cov_ap = cov_ops.per_base_coverage(
        aln.tid, aln.pos, aln.nmatch, [100])
    assert cov_ap[0] == 20            # approximation: [0,20) contiguous
    # difference shows in the depth layout: exact leaves [10,15) empty
    rec, s, e = cov_ops.m_segments(aln.pos, aln.cig_op, aln.cig_ln,
                                   aln.cig_off)
    assert list(s) == [0, 15] and list(e) == [10, 25]


def test_linkage_orientation_cases_and_cov_filter(rng):
    """-L parity: orientation signs per reference convention; pairs
    failing the inner-distance window dropped; coverage-balance filter
    (refiner.cpp:1244-1248, 1509-1512, 1537-1566)."""
    # contig 0 len 300, contig 1 len 300; IS 200 sd 10, read 100
    # max_allowed = 200+30-100 = 130
    flags_base = 0x1 | 0x40
    aln = FakeAln(
        tid=[0, 0, 0, 0], mtid=[1, 1, 1, 1],
        pos=[250, 250, 250, 100],     # last: l_inner=200 > 130 -> drop
        mpos=[20, 20, 20, 20],
        mapq=[60] * 4,
        # two FR pairs (mate reverse), one RF pair (read reverse)
        flag=[flags_base | 0x20, flags_base | 0x20, flags_base | 0x10,
              flags_base | 0x20],
        nmatch=[100] * 4, read_len=[100] * 4,
        lclip=[0] * 4, rclip=[0] * 4, tlen=[0] * 4)
    rows = refiner.cnt_contig_linkage(aln, [300, 300], ["A", "B"],
                                      insert_size=200, sd=10,
                                      read_length=100)
    # grouped by orientation: (+,+) x2 and (-,-) x1
    assert len(rows) == 2
    by_dir = {(r[3], r[7]): r for r in rows}
    assert by_dir[("+", "+")][8] == 2
    assert by_dir[("-", "-")][8] == 1
    # distance: 200 - (300-250) - (20+100) = 30
    assert by_dir[("+", "+")][9] == 30.0
    # coverage filter: contig 1 has zero coverage in this aln (no
    # records with tid=1) -> (max-min)/max = 1 -> cutoff 0.5 kills all
    rows2 = refiner.cnt_contig_linkage(aln, [300, 300], ["A", "B"],
                                       insert_size=200, sd=10,
                                       read_length=100, cov_cutoff=0.5)
    assert rows2 == []


def test_seeded_placement_scales_to_large_genome(rng):
    """Evaluate's placement path must work at real-draft scale: a 10 Mb
    finished genome, 100 flank queries incl. reverse-strand and small
    indels — seeded (minimizer + windowed DP) placement in seconds,
    instead of the O(|genome| x |query|) full scan."""
    import time
    from gappadder import dna

    L = 10_000_000
    seq = rng.integers(0, 4, L).astype(np.int8)
    finished = fasta.Genome(seq=seq, offsets=np.array([0]),
                            lengths=np.array([L]), names=["fin0"])
    t0 = time.time()
    queries, want = [], []
    for i in range(100):
        st = int(rng.integers(0, L - 400))
        q = seq[st:st + 295].copy()
        kind = i % 4
        if kind == 1:
            q = dna.revcomp(q)
        elif kind == 2:                      # 2bp deletion in the middle
            q = np.concatenate([q[:150], q[152:]])
        elif kind == 3:                      # 3bp insertion
            q = np.concatenate([q[:150], rng.integers(0, 4, 3).astype(np.int8),
                                q[150:]])
        queries.append(q)
        want.append((st, 1 if kind == 1 else 0))
    places = evaluate.seeded_placements(queries, finished)
    elapsed = time.time() - t0
    n_ok = 0
    for (st, strand), p in zip(want, places):
        if p is None:
            continue
        si, pstrand, ts, te, qs, qe, score = p
        if pstrand == strand and abs(ts - st) <= 8 and score >= 250:
            n_ok += 1
    assert n_ok >= 97, n_ok
    assert elapsed < 120, elapsed


def test_scaffold_overlap_merge_and_discard(rng):
    """-S pass-1 parity (scaffolding.cpp:34-133): negative-distance
    pairs with an anchored suffix/prefix overlap are trimmed-merged
    (dist field = -overlap); without one the connection is DISCARDED;
    the per-left-node ave_pe filter keeps only strong mates."""
    from gappadder import dna as _dna
    truth = rng.integers(0, 4, 520).astype(np.int8)
    A = truth[:300].copy()
    B = truth[280:].copy()                     # 20bp true overlap
    C = rng.integers(0, 4, 200).astype(np.int8)  # unrelated

    def row(i1, n1, l1, d1, i2, n2, l2, d2, np_, dmin, dmax, dmean):
        return (i1, n1, l1, d1, i2, n2, l2, d2, np_, dmin, dmax, dmean)

    # A->B negative distance WITH a real overlap: merged, trimmed
    links = [row(0, "A", 300, "+", 1, "B", 240, "+", 9, -20.0, -20.0,
                 -20.0)]
    recs, used = scaffold.build_scaffolds([A, B, C], ["A", "B", "C"],
                                          links)
    assert len(recs) == 1
    name, seq = recs[0]
    assert name == "A$+$B$+$-20"
    np.testing.assert_array_equal(seq, truth)   # exact trimmed join

    # A->C negative distance WITHOUT overlap: discarded entirely
    links2 = [row(0, "A", 300, "+", 2, "C", 200, "+", 9, -20.0, -20.0,
                  -20.0)]
    recs2, used2 = scaffold.build_scaffolds([A, B, C], ["A", "B", "C"],
                                            links2)
    assert recs2 == [] and used2 == set()

    # ave_pe filter: A has two mates with supports 10 and 2;
    # ave = (10+2)//2 = 6 -> only the support-10 mate is emitted
    links3 = [row(0, "A", 300, "+", 1, "B", 240, "+", 10, 15.0, 15.0,
                  15.0),
              row(0, "A", 300, "+", 2, "C", 200, "+", 2, 15.0, 15.0,
                  15.0)]
    recs3, _ = scaffold.build_scaffolds([A, B, C], ["A", "B", "C"],
                                        links3)
    assert [r[0] for r in recs3] == ["A$+$B$+$15"]
    # N-joint of int(mean_dist)
    assert (recs3[0][1][300:315] == _dna.N).all()

    # orientation: '-' takes the reverse complement of the right contig
    links4 = [row(0, "A", 300, "+", 1, "B", 240, "-", 9, 5.0, 5.0, 5.0)]
    recs4, _ = scaffold.build_scaffolds([A, B, C], ["A", "B", "C"],
                                        links4)
    np.testing.assert_array_equal(recs4[0][1][305:],
                                  _dna.revcomp(B))
