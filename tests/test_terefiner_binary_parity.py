"""Output parity against the PREBUILT reference TERefiner_1 binary.

The reference ships a compiled TERefiner_1 (/root/reference/TERefiner_1)
that runs standalone.  These tests feed it FASTA/BAM inputs generated by
THIS repo's writers and assert our columnar mode implementations
(tools/refiner.py) make identical decisions:

  -U  gnrtUniqueFa              refiner.cpp:1045-1117
  -P  removeDupRepeatsOfOneContigSet (+ -g)   refiner.cpp:660-801
  -K  removeContainedContigs    refiner.cpp:587-657
  -G  calcCoveageWithCutoff     refiner.cpp:1381-1451, Coverage.cpp:144-185
  -M  LocalAlignment::optAlign  local_alignment.cpp:1036-1047 (stdaln)

This is the same treatment the ContigsMerger already gets in
tests/test_reference_binary_parity.py: no reference code enters the
repo; the binary is an output oracle only.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import pytest

from gappadder import dna
from gappadder.io import bam, fasta
from gappadder.ops import sw_host
from gappadder.tools import refiner

REF_BIN = "/root/reference/TERefiner_1"
FIXDIR = "/root/reference/TERefiner/test_code"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_BIN), reason="reference TERefiner_1 missing")


@pytest.fixture(scope="module")
def ter_bin(tmp_path_factory):
    d = tmp_path_factory.mktemp("terbin")
    p = str(d / "TERefiner_1")
    shutil.copy(REF_BIN, p)
    os.chmod(p, 0o755)
    try:
        out = subprocess.run([p], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("TERefiner_1 binary not runnable here")
    if "parameters" not in (out.stdout + out.stderr):
        pytest.skip("TERefiner_1 binary produced unexpected output")
    return p


def _run(ter_bin, args, cwd):
    return subprocess.run([ter_bin] + args, capture_output=True,
                          text=True, timeout=300, cwd=str(cwd))


def _rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _write_fa(path, names, seqs):
    with open(path, "w") as f:
        for nm in names:
            f.write(f">{nm}\n{seqs[nm]}\n")
    fasta.write_fai(path)


def _kept_headers(path):
    with open(path) as f:
        return [ln[1:].split()[0] for ln in f if ln.startswith(">")]


# ---------------------------------------------------------------- -U --

def test_unique_fa_parity(ter_bin, tmp_path):
    rng = np.random.default_rng(7)
    names = ["c1", "c2", "c1", "c3", "c2", "c4", "c1"]
    seqs = {}
    lines = []
    for i, nm in enumerate(names):
        lines.append(f">{nm}\n{_rand_dna(rng, 60 + i)}\n")
    fa = tmp_path / "in.fa"
    fa.write_text("".join(lines))
    fasta.write_fai(str(fa))
    out = tmp_path / "out.fa"
    r = _run(ter_bin, ["-U", "-r", str(fa), "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    keep = refiner.unique_names(names)
    assert _kept_headers(out) == [names[i] for i in keep]


# ---------------------------------------------------- -P / -P -g / -K --

def _synth_self_bam(rng, tmp_path, tag, n_contigs=10, n_aln=30,
                    sort=False):
    """Random contig set + handcrafted contig-vs-self alignments with a
    mix of CIGAR shapes that straddle the fully/perfectly-mapped
    boundaries."""
    names = [f"tig{chr(ord('a') + i)}{rng.integers(10, 99)}"
             for i in range(n_contigs)]
    # ensure unique names (the pipeline runs -U before -P/-K)
    names = list(dict.fromkeys(names))
    seqs = {nm: _rand_dna(rng, int(rng.integers(50, 400)))
            for nm in names}
    fa = tmp_path / f"{tag}.fa"
    _write_fa(str(fa), names, seqs)
    refs = [(nm, len(seqs[nm])) for nm in names]
    recs = []
    for _ in range(n_aln):
        qi, ti = rng.integers(0, len(names), 2)
        qn, tn = names[qi], names[ti]
        qlen = len(seqs[qn])
        kind = rng.integers(0, 6)
        if kind == 0:      # perfect: single M over full length
            cig = [("M", qlen)]
        elif kind == 1:    # single M shorter than the contig
            cig = [("M", max(1, qlen - int(rng.integers(1, 20))))]
        elif kind == 2:    # high M-fraction with a small clip
            s = int(rng.integers(1, 4))
            cig = [("S", s), ("M", qlen - s)]
        elif kind == 3:    # mid M-fraction: big clip
            s = int(rng.integers(qlen // 4, qlen // 2 + 1))
            cig = [("M", qlen - s), ("S", s)]
        elif kind == 4:    # insertion-bearing
            i_ = int(rng.integers(1, 6))
            m1 = (qlen - i_) // 2
            cig = [("M", m1), ("I", i_), ("M", qlen - i_ - m1)]
        else:              # deletion-bearing (D not in denominator)
            m1 = qlen // 2
            cig = [("M", m1), ("D", int(rng.integers(1, 6))),
                   ("M", qlen - m1)]
        recs.append(dict(name=qn, flag=0, tid=int(ti),
                         pos=int(rng.integers(0, 5)), mapq=60,
                         cigar=cig, seq=seqs[qn]))
    if sort:
        recs.sort(key=lambda r: (r["tid"], r["pos"]))
    bpath = tmp_path / f"{tag}.bam"
    bam.write_bam(str(bpath), refs, recs)
    return fa, bpath, names, seqs


@pytest.mark.parametrize("trial", range(6))
def test_remove_dup_parity(ter_bin, tmp_path, trial):
    rng = np.random.default_rng(100 + trial)
    cutoff = [0.9, 0.95, 0.99][trial % 3]
    fa, bpath, names, seqs = _synth_self_bam(rng, tmp_path, f"p{trial}")
    out = tmp_path / f"p{trial}.out.fa"
    r = _run(ter_bin, ["-P", "-b", str(bpath), "-r", str(fa),
                       "-c", str(cutoff), "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    aln = bam.read_bam(str(bpath), keep_names=True, keep_cigars=True)
    keep = refiner.remove_dup_contigs(
        aln, names, [len(seqs[nm]) for nm in names], cutoff)
    assert _kept_headers(out) == [names[i] for i in keep]


@pytest.mark.parametrize("trial", range(4))
def test_remove_dup_g_parity(ter_bin, tmp_path, trial):
    rng = np.random.default_rng(200 + trial)
    cutoff = 0.95
    fa, bpath, names, seqs = _synth_self_bam(rng, tmp_path, f"g{trial}")
    out = tmp_path / f"g{trial}.out.fa"
    r = _run(ter_bin, ["-P", "-g", "-b", str(bpath), "-r", str(fa),
                       "-c", str(cutoff), "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    aln = bam.read_bam(str(bpath), keep_names=True, keep_cigars=True)
    keep = refiner.remove_dup_contigs(
        aln, names, [len(seqs[nm]) for nm in names], cutoff,
        rm_contained=True)
    assert _kept_headers(out) == [names[i] for i in keep]


@pytest.mark.parametrize("trial", range(4))
def test_remove_contained_oracle(tmp_path, trial):
    """-K is absent from the SHIPPED binary's getopt string (older
    build than the source tree), so it can't be binary-oracled; its
    fully-mapped core is binary-oracled through -P above.  Here the
    columnar implementation is checked against a literal per-record
    transcription of refiner.cpp:587-657."""
    rng = np.random.default_rng(300 + trial)
    cutoff = [0.9, 0.99][trial % 2]
    fa, bpath, names, seqs = _synth_self_bam(rng, tmp_path, f"k{trial}")
    aln = bam.read_bam(str(bpath), keep_names=True, keep_cigars=True)
    keep = refiner.remove_contained_contigs(
        aln, names, [len(seqs[nm]) for nm in names], cutoff)
    # literal oracle
    rm = set()
    for i in range(aln.n):
        qn = aln.names[i].decode()
        rn = names[int(aln.tid[i])]
        if qn == rn:
            continue
        o0, o1 = int(aln.cig_off[i]), int(aln.cig_off[i + 1])
        ops = [("MIDNSHP=X"[aln.cig_op[k]], int(aln.cig_ln[k]))
               for k in range(o0, o1)]
        qlen = len(seqs[qn])
        if len(ops) == 1 and ops[0][0] == "M" and ops[0][1] <= qlen:
            full = True
        else:
            cnt = sum(l for o, l in ops if o == "M")
            tot = cnt + sum(l for o, l in ops if o in "SHI")
            full = tot > 0 and cnt / tot > cutoff
        if full:
            rm.add(qn)
    assert [names[i] for i in keep] == [nm for nm in names
                                        if nm not in rm]


# ----------------------------------------------------------- -G / -B --
#
# Both coverage modes region-query the BAM per contig, so they need an
# index: these tests exercise our .bai writer (io/bam.write_bam
# index=True) end to end through BamTools' own reader.
#
# BamTools region-iteration quirk (observed empirically, determines
# test construction): finishing region k consumes one record past the
# region (the first record of contig k+1) and the reader does not seek
# backwards for the next sequential SetRegion, so the FIRST record of
# every contig after the first is silently dropped by the binary.  Each
# contig therefore starts with a qcfail-flagged decoy record that both
# sides filter out, making the comparison exact.

def _synth_sorted_bam(rng, tmp_path, tag, clip_all=False,
                      decoy_flag=0x200, decoy_cigar=(("M", 1),)):
    names = [f"ctg{i}" for i in range(6)]
    lens = [int(rng.integers(300, 30000)) for _ in names]
    seqs = {n: _rand_dna(rng, l) for n, l in zip(names, lens)}
    fa = tmp_path / f"{tag}.fa"
    _write_fa(str(fa), names, seqs)
    refs = list(zip(names, lens))
    recs = []
    for t, (n, L) in enumerate(refs):
        recs.append(dict(name=f"decoy{t}", flag=decoy_flag, tid=t,
                         pos=0, mapq=0, cigar=list(decoy_cigar),
                         seq="A"))
        poss = sorted(int(p) for p in
                      rng.integers(0, max(1, L - 130),
                                   int(rng.integers(5, 40))))
        for j, p in enumerate(poss):
            ml = min(int(rng.integers(20, 101)), L - p)
            kind = int(rng.integers(0, 3))
            if clip_all or kind == 1:
                cig = [("S", 10), ("M", ml)]
            elif kind == 0:
                cig = [("M", ml)]
            else:
                cig = [("M", ml // 2), ("D", 3), ("M", ml - ml // 2)]
            if clip_all and kind == 2:
                cig = [("S", 5), ("M", ml // 2), ("D", 3),
                       ("M", ml - ml // 2)]
            slen = sum(l for o, l in cig if o in ("M", "S", "I"))
            flag = 0x400 if (j % 11 == 10) else 0   # some duplicates
            recs.append(dict(name=f"r{t}_{j}", flag=flag, tid=t,
                             pos=p, mapq=60, cigar=cig, seq="A" * slen))
    bpath = tmp_path / f"{tag}.bam"
    bam.write_bam(str(bpath), refs, recs, index=True)
    assert os.path.exists(str(bpath) + ".bai")
    return fa, bpath, names, lens


@pytest.mark.parametrize("trial", range(3))
def test_coverage_cutoff_binary_parity(ter_bin, tmp_path, trial):
    rng = np.random.default_rng(500 + trial)
    cutoff, read_len = [(0.3, 100), (0.5, 80), (0.0, 100)][trial]
    fa, bpath, names, lens = _synth_sorted_bam(rng, tmp_path, f"g{trial}")
    opref = tmp_path / "cov"
    r = _run(ter_bin, ["-G", "-b", str(bpath), "-r", str(fa),
                       "-c", str(cutoff), "-o", str(opref),
                       "-l", str(read_len)], tmp_path)
    assert r.returncode == 0, r.stderr
    want = {}
    with open(str(opref) + "_cov_info_with_cutoff.txt") as f:
        for ln in f:
            parts = ln.split()
            if ln.startswith("Total") or len(parts) != 3:
                continue
            want[parts[0]] = (int(parts[1]), float(parts[2]))
    assert set(want) == set(names)
    aln = bam.read_bam(str(bpath), keep_cigars=True)
    ours = refiner.coverage_with_cutoff_exact(aln, lens, cutoff, read_len)
    for i, nm in enumerate(names):
        wl, wc = want[nm]
        assert wl == lens[i]
        # C++ prints 6 significant digits
        assert ours[i] == pytest.approx(wc, rel=1e-4, abs=1e-6), nm


@pytest.mark.parametrize("trial", range(2))
def test_per_base_coverage_binary_parity(ter_bin, tmp_path, trial):
    """-B calcCoverage vs our exact M-segment pileup.

    All records carry a soft clip so the binary classifies every one
    READ_TYPE_CLIP and walks true M/D segments (Coverage.cpp:75-105) —
    the branch our per_base_coverage mirrors.  (Unclipped reads take
    the FULLMAP branch, which covers a flat READ_LENGTH-long span from
    pos — a quirk of the global -l parameter our sane pileup
    deliberately does not copy, so they are excluded here.)"""
    rng = np.random.default_rng(600 + trial)
    fa, bpath, names, lens = _synth_sorted_bam(rng, tmp_path,
                                               f"b{trial}", clip_all=True)
    opref = tmp_path / "covb"
    r = _run(ter_bin, ["-B", "-b", str(bpath), "-r", str(fa),
                       "-o", str(opref), "-l", "100"], tmp_path)
    assert r.returncode == 0, r.stderr
    want = {}
    with open(str(opref) + "_before_filter_cov_info.txt") as f:
        for ln in f:
            parts = ln.split()
            if len(parts) != 4:
                continue
            want[parts[0]] = (float(parts[2]), int(parts[3]))
    assert set(want) == set(names)
    aln = bam.read_bam(str(bpath), keep_cigars=True)
    flag = np.asarray(aln.flag)
    keep = (flag & (0x400 | 0x100 | 0x200)) == 0
    sub = bam.Alignments(
        tid=aln.tid[keep], pos=aln.pos[keep], flag=flag[keep],
        mapq=aln.mapq[keep], mtid=aln.mtid[keep], mpos=aln.mpos[keep],
        tlen=aln.tlen[keep], lclip=aln.lclip[keep],
        rclip=aln.rclip[keep], nmatch=aln.nmatch[keep],
        read_len=aln.read_len[keep], name_hash=aln.name_hash[keep],
        refs=aln.refs,
        cig_op=aln.cig_op, cig_ln=aln.cig_ln, cig_off=aln.cig_off)
    # rebuild ragged cigars for the kept subset
    off = np.asarray(aln.cig_off)
    starts, stops = off[:-1][keep], off[1:][keep]
    sel = np.concatenate([np.arange(s, e) for s, e in
                          zip(starts, stops)]) if keep.any() else \
        np.zeros(0, np.int64)
    sub.cig_op = np.asarray(aln.cig_op)[sel]
    sub.cig_ln = np.asarray(aln.cig_ln)[sel]
    sub.cig_off = np.concatenate(
        [[0], np.cumsum(stops - starts)]).astype(np.int32)
    mean, covlen = refiner.calc_coverage(sub, lens)
    for i, nm in enumerate(names):
        wm, wl = want[nm]
        assert covlen[i] == wl, nm
        assert mean[i] == pytest.approx(wm, rel=1e-4, abs=1e-6), nm


@pytest.mark.parametrize("trial", range(2))
def test_evaluate_benchmark_binary_parity(ter_bin, tmp_path, trial):
    """-E evaluateWithBenchmark vs our evaluate_with_benchmark table
    fields (total covered region, longest qualified single cover,
    total mapped bases).  -E applies NO flag filters, so the decoy is
    a mapped 1I record (zero M bases on both sides) rather than a
    qcfail one."""
    rng = np.random.default_rng(700 + trial)
    cutoff = [0.0, 0.2][trial]
    fa, bpath, names, lens = _synth_sorted_bam(
        rng, tmp_path, f"e{trial}", clip_all=True,
        decoy_flag=0, decoy_cigar=(("I", 1),))
    r = _run(ter_bin, ["-E", "-b", str(bpath), "-r", str(fa),
                       "-c", str(cutoff)], tmp_path)
    assert r.returncode == 0, r.stderr
    rows = {}
    with open(str(bpath) + ".statistic.table.txt") as f:
        next(f)  # header
        for ln in f:
            p = ln.rstrip("\n").split("\t")
            if len(p) != 8:
                continue
            rows[p[0]] = (int(p[1]), int(p[2]), int(p[4]), int(p[6]))
    aln = bam.read_bam(str(bpath), keep_cigars=True)
    res = refiner.evaluate_with_benchmark(aln, lens, cutoff)
    for i, nm in enumerate(names):
        if int(res["longest_single"][i]) <= 0:
            assert nm not in rows, nm    # binary skips max_match<=0 rows
            continue
        wl, wcov, wmax, wmapped = rows[nm]
        assert wl == lens[i]
        assert wcov == int(res["total_covered"][i]), nm
        assert wmax == int(res["longest_single"][i]), nm
        assert wmapped == int(res["total_mapped_bases"][i]), nm


# ---------------------------------------------------------------- -M --

STDALN_BLAST = sw_host.SWParams(match=1, mismatch=-3, gap_open=7,
                                gap_extend=2)
"""aln_param_blast: +1/-3, gap open 5 + ext 2 per base (first base
costs open+ext in stdaln's recurrence)."""


@pytest.mark.parametrize("trial", range(8))
def test_optalign_coordinate_parity(ter_bin, tmp_path, trial):
    """Plant a unique shared segment (with sprinkled mismatches) inside
    random flanks; stdaln's reported 1-based local-alignment
    coordinates must equal our local SW traceback."""
    rng = np.random.default_rng(400 + trial)
    seg = _rand_dna(rng, int(rng.integers(30, 80)))
    # sprinkle <=2 interior mismatches (keeps the optimum unique and
    # extension through them profitable at +1/-3)
    seg2 = list(seg)
    for _ in range(int(rng.integers(0, 3))):
        p = int(rng.integers(5, len(seg) - 5))
        seg2[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[seg2[p]]
    seg2 = "".join(seg2)
    ref = _rand_dna(rng, int(rng.integers(10, 40))) + seg + \
        _rand_dna(rng, int(rng.integers(10, 40)))
    sgmt = _rand_dna(rng, int(rng.integers(0, 15))) + seg2 + \
        _rand_dna(rng, int(rng.integers(0, 15)))
    r = _run(ter_bin, ["-M", "-r", ref, "-s", sgmt], tmp_path)
    assert r.returncode == 0, r.stderr
    rs, re_, ss, se = map(int, r.stdout.split()[:4])
    q = dna.encode(sgmt)
    t = dna.encode(ref)
    score, qend, tend, _ = sw_host.sw_np(q, t, STDALN_BLAST, "local")
    qstart, tstart, _ = sw_host.traceback(q, t, STDALN_BLAST, "local",
                                          qend, tend)
    # stdaln coordinates are 1-based inclusive: start1/end1 = ref,
    # start2/end2 = segment
    assert (rs, re_, ss, se) == (tstart + 1, tend, qstart + 1, qend)


# ------------------------------------------------------------ -T / -O --

def _synth_two_set_bam(rng, tmp_path, tag, n_q=8, n_r=6, n_aln=24):
    """Query set + reference set + query-vs-reference alignments with
    adversarial shapes: full maps of LONGER queries onto shorter
    reference contigs (the -T asymmetry), partial maps at the cutoff
    boundary, queries hit multiple times."""
    qnames = [f"q{chr(ord('a') + i)}{rng.integers(10, 99)}"
              for i in range(n_q)]
    qnames = list(dict.fromkeys(qnames))
    rnames = [f"r{chr(ord('a') + i)}{rng.integers(10, 99)}"
              for i in range(n_r)]
    rnames = list(dict.fromkeys(rnames))
    qseqs = {nm: _rand_dna(rng, int(rng.integers(50, 400)))
             for nm in qnames}
    rseqs = {nm: _rand_dna(rng, int(rng.integers(50, 400)))
             for nm in rnames}
    qfa = tmp_path / f"{tag}_q.fa"
    rfa = tmp_path / f"{tag}_r.fa"
    _write_fa(str(qfa), qnames, qseqs)
    _write_fa(str(rfa), rnames, rseqs)
    refs = [(nm, len(rseqs[nm])) for nm in rnames]
    recs = []
    for _ in range(n_aln):
        qn = qnames[rng.integers(0, len(qnames))]
        ti = int(rng.integers(0, len(rnames)))
        qlen = len(qseqs[qn])
        kind = rng.integers(0, 4)
        if kind == 0:
            cig = [("M", qlen)]                      # full map
        elif kind == 1:
            s = int(rng.integers(1, 4))
            cig = [("S", s), ("M", qlen - s)]        # near-cutoff
        elif kind == 2:
            s = int(rng.integers(qlen // 3, qlen // 2 + 1))
            cig = [("M", qlen - s), ("S", s)]        # below cutoff
        else:
            i_ = int(rng.integers(1, 6))
            m1 = (qlen - i_) // 2
            cig = [("M", m1), ("I", i_), ("M", qlen - i_ - m1)]
        recs.append(dict(name=qn, flag=0, tid=ti,
                         pos=int(rng.integers(0, 5)), mapq=60,
                         cigar=cig, seq=qseqs[qn]))
    recs.sort(key=lambda r: (r["tid"], r["pos"]))   # -T region queries
    bpath = tmp_path / f"{tag}.bam"
    bam.write_bam(str(bpath), refs, recs)
    return qfa, rfa, bpath, qnames, qseqs


@pytest.mark.parametrize("trial", range(4))
def test_remove_repeats_two_sets_parity(ter_bin, tmp_path, trial):
    """-T removeRepeatsOfTwoContigSets (refiner.cpp:300-392): binary
    parity incl. the cross-set asymmetry (long query fully mapped onto
    a short reference contig is still dropped)."""
    rng = np.random.default_rng(700 + trial)
    cutoff = [0.9, 0.95][trial % 2]
    qfa, rfa, bpath, qnames, qseqs = _synth_two_set_bam(
        rng, tmp_path, f"t{trial}")
    out = tmp_path / f"t{trial}.out.fa"
    r = _run(ter_bin, ["-T", "-b", str(bpath), "-r", str(rfa),
                       "-s", str(qfa), "-c", str(cutoff),
                       "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    aln = bam.read_bam(str(bpath), keep_names=True, keep_cigars=True)
    keep = refiner.remove_repeats_two_sets(
        aln, qnames, [len(qseqs[nm]) for nm in qnames], cutoff)
    assert _kept_headers(out) == [qnames[i] for i in keep]


def _synth_one_set_bam(rng, tmp_path, tag):
    """Contig-vs-self set engineered for the -O decision rules: pairs
    with EQUAL lengths (both name orders), a long query fully mapped
    onto a short target (dropped anyway), and sub-cutoff maps."""
    L = int(rng.integers(80, 200))
    names = ["a_eq", "b_eq", "long1", "short1", "partial1", "alone"]
    seqs = {"a_eq": _rand_dna(rng, L), "b_eq": _rand_dna(rng, L),
            "long1": _rand_dna(rng, 2 * L),
            "short1": _rand_dna(rng, L // 2),
            "partial1": _rand_dna(rng, L),
            "alone": _rand_dna(rng, L + 7)}
    fa = tmp_path / f"{tag}.fa"
    _write_fa(str(fa), names, seqs)
    refs = [(nm, len(seqs[nm])) for nm in names]
    tidx = {nm: i for i, nm in enumerate(names)}

    def rec(qn, tn, cig):
        return dict(name=qn, flag=0, tid=tidx[tn], pos=0, mapq=60,
                    cigar=cig, seq=seqs[qn])

    recs = [
        # equal lengths, both orders: only the lexicographically
        # smaller qname (a_eq onto b_eq) is removed
        rec("a_eq", "b_eq", [("M", L)]),
        rec("b_eq", "a_eq", [("M", L)]),
        # LONGER query fully mapped onto a shorter contig: the
        # reference's else-branch drops it regardless of length
        rec("long1", "short1", [("M", 2 * L)]),
        # below-cutoff map: survives
        rec("partial1", "a_eq", [("M", L // 2), ("S", L - L // 2)]),
        # self-hit: ignored (qname == rname)
        rec("alone", "alone", [("M", L + 7)]),
    ]
    rng.shuffle(recs)
    recs.sort(key=lambda r: r["tid"])      # coordinate-sorted per tid
    bpath = tmp_path / f"{tag}.bam"
    bam.write_bam(str(bpath), refs, recs)
    return fa, bpath, names, seqs


@pytest.mark.parametrize("trial", range(3))
def test_remove_repeats_one_set_parity(ter_bin, tmp_path, trial):
    """-O removeRepeatsOfOneContigSet (refiner.cpp:482-585): binary
    parity on the engineered decision-rule cases."""
    rng = np.random.default_rng(800 + trial)
    fa, bpath, names, seqs = _synth_one_set_bam(rng, tmp_path,
                                                f"o{trial}")
    out = tmp_path / f"o{trial}.out.fa"
    r = _run(ter_bin, ["-O", "-b", str(bpath), "-r", str(fa),
                       "-c", "0.9", "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    aln = bam.read_bam(str(bpath), keep_names=True, keep_cigars=True)
    keep = refiner.remove_repeats_one_set(
        aln, names, [len(seqs[nm]) for nm in names], 0.9)
    assert _kept_headers(out) == [names[i] for i in keep]
    # rule spot-checks
    kept = {names[i] for i in keep}
    assert "b_eq" in kept and "a_eq" not in kept
    assert "long1" not in kept        # longer-but-dropped asymmetry
    assert {"partial1", "alone", "short1"} <= kept


@pytest.mark.parametrize("trial", range(3))
def test_remove_repeats_one_set_random_parity(ter_bin, tmp_path, trial):
    """-O on randomized self-alignment soup (same generator as -P, but
    coordinate-sorted: -O reads via indexed region queries)."""
    rng = np.random.default_rng(900 + trial)
    fa, bpath, names, seqs = _synth_self_bam(rng, tmp_path,
                                             f"or{trial}", sort=True)
    out = tmp_path / f"or{trial}.out.fa"
    r = _run(ter_bin, ["-O", "-b", str(bpath), "-r", str(fa),
                       "-c", "0.95", "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr
    aln = bam.read_bam(str(bpath), keep_names=True, keep_cigars=True)
    keep = refiner.remove_repeats_one_set(
        aln, names, [len(seqs[nm]) for nm in names], 0.95)
    assert _kept_headers(out) == [names[i] for i in keep]
