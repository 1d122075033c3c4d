"""Composed full-driver oracle: the reference pipeline flow end to end
vs our CLI, asserting picked_seqs.fa EQUALITY (VERDICT r4 missing #1).

The reference driver flow (/root/reference/main.py:196-275 ->
assemble_gaps.py:328-368 -> pick_contigs.py:97-358) is re-composed here
from the per-stage literal oracles this suite already maintains, plus
the REAL ContigsMerger binary compiled from /root/reference for the
merge step:

  gap scan + flanks       literal N-run scan + flank slice rules
                          (gnrt_pos_true_seqs.py:12-100 semantics,
                          minus the documented pos+2 / negative-slice
                          bugs, PARITY.md P3)
  collect                 tests/reference_oracle.py (the literal Py3
                          transcription of the collect scripts)
  KMC                     python-set distinct canonical k-mers
                          (kmc -ci0, assemble_gaps.py:96-102)
  Velvet                  the dict-based brute-force DBG oracle
                          (tests/test_dbg_oracle.py), slot-ordered
                          like the device emitter (length desc, head
                          node rank)
  dedup (-U/-P/-K)        all-pairs containment/near-dup decision rule
                          (refiner semantics as documented in
                          PARITY.md C2), NO sketch pruning — if the
                          pipeline's sketch screen ever wrongly prunes
                          a pair, this diverges and the test fails
  ContigsMerger           the compiled reference binary itself
                          (MergeContigs.py:85-88 exact arguments)
  pick                    the literal combo/selection oracle
                          (tests/test_pick_oracle.py), fed the same
                          flank hits (hit generation = the SW kernel,
                          itself binary-oracled vs stdaln via -M)

Any undocumented semantic drift in a stage OR in how stages compose
(gap-id threading, read-set flow, contig naming/order) changes the
final FASTA and fails the test. Extension/rescue paths are exercised
by tests/test_end_to_end.py; this composition covers the full-closure
driver including a repeat-split gap where the merge step genuinely
fires through the binary.
"""

import json
import os
import subprocess

import numpy as np
import pytest

from gappadder import dna
from gappadder.io import fasta
from gappadder.ops import sw_host
from gappadder.pipeline import pick as pick_mod

import read_simulator
import reference_oracle as oracle
from test_dbg_oracle import _oracle_unitigs, _revcomp_s
from test_pick_oracle import _oracle as pick_oracle
from test_reference_binary_parity import (ref_binary,  # noqa: F401
                                          run_reference_merger)

MARGIN = 5          # flank safety margin (gnrt_pos_true_seqs.py:59-100)


# ---------------------------------------------------------------------------
# oracle stages
# ---------------------------------------------------------------------------

def oracle_gaps(draft_records, min_gap_size, flank_len):
    """[(scaffold_idx, gapnum, start, end, flank_l, flank_r)] per the
    reference scan semantics (N-runs >= min_gap_size, per-scaffold
    counter from 1, flanks of flank_len - margin ending margin short of
    the gap)."""
    out = []
    for sid, (name, seq) in enumerate(draft_records):
        cnt = 0
        i = 0
        while i < len(seq):
            if seq[i] == "N":
                j = i
                while j < len(seq) and seq[j] == "N":
                    j += 1
                # trailing N-runs are dropped (reference behavior)
                if j - i >= min_gap_size and j < len(seq):
                    cnt += 1
                    fl = seq[max(i - flank_len, 0):max(i - MARGIN, 0)]
                    fr = seq[min(j + MARGIN, len(seq)):
                             min(j + flank_len, len(seq))]
                    out.append((sid, cnt, i, j, fl, fr))
                i = j
            else:
                i += 1
    return out


def oracle_collect(bam_records, scaffold_names, scaffold_gaps,
                   insert_size, std, clip_dist, anchor_mapq):
    """reference_oracle composition -> {(sid, gapnum): set[(side, name)]}."""
    scaffold_index = {n: i for i, n in enumerate(scaffold_names)}
    by_scaf = {n: [] for n in scaffold_names}
    for r in bam_records:
        if r["tid"] < 0:
            continue
        sname = scaffold_names[r["tid"]]
        lclip = rclip = 0
        cig = r.get("cigar") or []
        if cig and cig[0][0] == "S":
            lclip = cig[0][1]
        if cig and cig[-1][0] == "S":
            rclip = cig[-1][1]
        mate_same = r["mtid"] == r["tid"]
        by_scaf[sname].append(dict(
            name=r["name"], flag=r["flag"], pos1=r["pos"] + 1,
            mapq=r["mapq"], mate_ref_same=mate_same,
            mate_scaffold=(scaffold_names[r["mtid"]]
                           if r["mtid"] >= 0 else None),
            mate_pos1=r["mpos"] + 1, tlen=r["tlen"],
            lclip=lclip, rclip=rclip))
    lists = {n: oracle.classify_scaffold(
        by_scaf[n], scaffold_gaps.get(n, []), insert_size=insert_size,
        std=std, dist_clip=clip_dist, anchor_mapq=anchor_mapq)
        for n in scaffold_names}
    inverted = oracle.invert_discordant(lists, scaffold_index)
    low = oracle.lowmapq_pass(by_scaf, inverted, scaffold_index,
                              scaffold_names)
    lmap, rmap = oracle.union_recruits(lists, low, scaffold_index)
    per_gap = {}
    for side, mp in ((0, lmap), (1, rmap)):
        for name, gaps in mp.items():
            for key in gaps:
                per_gap.setdefault(key, set()).add((side, name))
    return per_gap


def oracle_assemble(read_seqs, kset, min_contig_len):
    """KMC + Velvet oracle for one gap: distinct canonical k-mers of
    the read set, DBG unitigs per (k, sub_k), pipeline naming/slot
    order (length desc, then head-node rank among sorted nodes) with
    per-unique-k k-mer reuse."""
    contigs, names = [], []
    kmer_cache = {}
    for (k, sub_k) in kset:
        if k not in kmer_cache:
            ks = set()
            for s in read_seqs:
                for i in range(len(s) - k + 1):
                    sub = s[i:i + k]
                    if "N" in sub:
                        continue
                    ks.add(min(sub, _revcomp_s(sub)))
            kmer_cache[k] = sorted(ks)
        kstr = kmer_cache[k]
        unis = _oracle_unitigs(kstr, sub_k, min_len=min_contig_len)
        # device slot order: emitted top-by-length (stable by head node
        # rank); canonical strand already applied by the oracle
        nodes = sorted({s[i:i + sub_k]
                        for s in kstr + [_revcomp_s(x) for x in kstr]
                        for i in range(len(s) - sub_k + 1)})
        rank = {n: i for i, n in enumerate(nodes)}
        ordered = sorted(unis, key=lambda s: (-len(s), rank[s[:sub_k]]))
        for i, s in enumerate(ordered):
            contigs.append(dna.encode(s))
            names.append(f"{k}_{sub_k}_{i}")
    return contigs, names


def _local_score(q, t):
    s, _, _, _ = sw_host.sw_np(np.asarray(q), np.asarray(t),
                               sw_host.SWParams(1, -4, 7, 1), "local")
    return int(s)


def oracle_dedup(contigs, names, cutoff=0.99):
    """All-pairs duplicate/containment removal (TERefiner -U/-P/-K
    composite semantics, PARITY.md C2): drop exact dups (either
    strand), then drop i when it aligns into a LONGER j at >= cutoff
    of its length (containment, -K), or into an equal-length j with
    i > j (near-dup, -P qname>rname rule). NO candidate pruning."""
    keep = [True] * len(contigs)
    seen = {}
    for i, c in enumerate(contigs):
        key = dna.decode(c)
        rkey = _revcomp_s(key)
        if key in seen or rkey in seen:
            keep[i] = False
        else:
            seen[key] = i
    for i in range(len(contigs)):
        if not keep[i]:
            continue
        for j in range(len(contigs)):
            if i == j or not keep[j] or not keep[i]:
                continue
            li, lj = len(contigs[i]), len(contigs[j])
            if li > lj:
                continue
            sc = max(_local_score(contigs[i], contigs[j]),
                     _local_score(dna.revcomp(contigs[i]), contigs[j]))
            if sc >= cutoff * li:
                if li < lj:
                    keep[i] = False
                elif lj * (1.0 - cutoff) >= abs(li - lj) and i > j:
                    keep[i] = False
    idx = [i for i in range(len(contigs)) if keep[i]]
    return [contigs[i] for i in idx], [names[i] for i in idx]


def oracle_pick(contigs, names, flank_l, flank_r, min_score,
                max_hits=3):
    """Flank hits (shared SW hit generation) + the literal pick combo
    oracle -> (picked name, gap sequence) or None."""
    C = len(contigs)
    if C == 0:
        return None
    Lmax = max(len(c) for c in contigs)
    seq = np.full((1, C, Lmax), dna.N, np.int8)
    lens = np.zeros((1, C), np.int32)
    for i, c in enumerate(contigs):
        seq[0, i, :len(c)] = c
        lens[0, i] = len(c)
    fl = np.asarray(dna.encode(flank_l), np.int8)[None]
    fr = np.asarray(dna.encode(flank_r), np.int8)[None]
    hits = pick_mod.align_flanks_to_contigs(
        fl, fr, seq, lens, np.array([C], np.int32),
        min_score=min_score, max_hits=max_hits)
    res = pick_oracle(hits[0], lens[0])
    if res is None:
        return None
    c, s, e, rc = res
    span = np.asarray(contigs[c][s:e])
    if rc:
        span = dna.revcomp(span)
    return names[c], dna.decode(span)


# ---------------------------------------------------------------------------
# the composed scenario
# ---------------------------------------------------------------------------

KSET = [(25, 21), (25, 19)]


def test_full_driver_composed_oracle(ref_binary, tmp_path, rng):  # noqa: F811
    from gappadder.cli import main

    flank_len, min_gap = 150, 50
    b = np.array(list("ACGT"))

    def rand(n):
        return "".join(b[rng.integers(0, 4, n)])

    # 3 clean gaps + 1 repeat-split gap (a 22-mer repeated twice inside
    # the gap splits every sub_k<=21 DBG into >=3 unitigs, so the merge
    # step genuinely runs through the binary)
    rep = rand(22)
    fills = [rand(140), rand(90), rand(200),
             rand(40) + rep + rand(50) + rep + rand(40)]
    seg = [rand(400)]
    spans = []
    pos = 400
    for f in fills:
        spans.append((pos, pos + len(f)))
        seg.append(f)
        seg.append(rand(400))
        pos += len(f) + 400
    truth = "".join(seg)
    draft = list(truth)
    for (s, e) in spans:
        draft[s:e] = "N" * (e - s)
    draft = "".join(draft)
    fasta.write_fasta(tmp_path / "draft.fa", [("scaf0", draft)])

    bam_records, lfq, rfq = read_simulator.simulate(
        truth, spans, 2600, rng, read_len=100, insert=300, std=30)
    from gappadder.io import bam as bam_io
    bam_io.write_bam(str(tmp_path / "lib.bam"),
                     [("scaf0", len(truth))], bam_records)
    for path, entries in ((tmp_path / "lib_1.fastq", lfq),
                          (tmp_path / "lib_2.fastq", rfq)):
        with open(path, "w") as fh:
            for name, seq in entries:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")

    cfg = {
        "draft_genome": {"fa": "draft.fa"},
        "alignments": [{"bam": "lib.bam", "is": 300, "std": 30}],
        "raw_reads": [{"left": "lib_1.fastq", "right": "lib_2.fastq"}],
        "kmer_length": [{"k": 25, "k_velvet": [{"k": 21}, {"k": 19}]}],
        "parameters": {"working_folder": "work", "min_gap_size": min_gap,
                       "flank_length": flank_len, "nthreads": 1,
                       "verbose": 0},
        "device": {"read_batch": 8192},
    }
    (tmp_path / "work").mkdir()
    with open(tmp_path / "config.json", "w") as fh:
        json.dump(cfg, fh)
    rc = main(["-c", "All", "-g", str(tmp_path / "config.json")])
    assert rc == 0
    got = {name: dna.decode(seq) for name, seq in
           fasta.iter_fasta(tmp_path / "work/picked_seqs.fa")}

    # ---- the composed oracle -------------------------------------------
    gaps = oracle_gaps([("scaf0", draft)], min_gap, flank_len)
    assert len(gaps) == len(fills)
    per_gap = oracle_collect(bam_records, ["scaf0"],
                             {"scaf0": [(s, e) for (s, e) in spans]},
                             insert_size=300, std=30, clip_dist=250,
                             anchor_mapq=30)
    lfq_by_name = {n.rsplit("/", 1)[0]: s for n, s in lfq}
    rfq_by_name = {n.rsplit("/", 1)[0]: s for n, s in rfq}

    want = {}
    for (sid, gapnum, gs, ge, fl, fr) in gaps:
        members = per_gap.get((sid, gapnum), set())
        reads = [(lfq_by_name if side == 0 else rfq_by_name)[name]
                 for (side, name) in members]
        contigs, names = oracle_assemble(reads, KSET, min_contig_len=40)
        contigs, names = oracle_dedup(contigs, names)
        if contigs and sum(len(c) for c in contigs) <= (1 << 20) \
                and len(contigs) >= 1:
            merged, _info = run_reference_merger(
                ref_binary, contigs, names, str(tmp_path))
            for mname in sorted(
                    merged, key=lambda n: int(n.rsplit("_", 1)[1])):
                contigs.append(dna.encode(merged[mname]))
                names.append(mname)
            if merged:
                contigs, names = oracle_dedup(contigs, names)
        res = oracle_pick(contigs, names, fl, fr, min_score=30)
        if res is None:
            res = oracle_pick(contigs, names, fl, fr, min_score=15)
        assert res is not None, f"oracle failed to close gap {sid}_{gapnum}"
        cname, seq = res
        want[f"{sid}_{gapnum}_{cname}"] = seq

    assert got == want
