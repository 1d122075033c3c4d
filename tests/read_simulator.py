"""Synthetic paired-end read + alignment simulator for e2e tests.

Samples FR paired reads from a TRUE genome, then emits the BAM records
a mapper would produce against the DRAFT (the truth with gap regions
replaced by Ns): reads overlapping a gap are soft-clipped at the gap
edge (or unmapped when the anchor is too short), reads inside a gap
are unmapped-at-mate-position, everything else maps cleanly at its
true coordinate with mapq 60.
"""

from __future__ import annotations

import numpy as np

from gappadder import dna
from gappadder.io import bam as bam_io

MIN_ANCHOR = 20


def _align_one(a, b, gaps):
    """Map read interval [a, b) against gap list [(gs, ge)].

    Returns None (unmapped) or (pos, cigar, lclip, rclip) with pos the
    0-based mapped start."""
    L = b - a
    for gs, ge in gaps:
        if b <= gs or a >= ge:
            continue
        left_anchor = max(0, gs - a)
        right_anchor = max(0, b - ge)
        if left_anchor >= MIN_ANCHOR and left_anchor >= right_anchor:
            return a, [("M", left_anchor), ("S", L - left_anchor)]
        if right_anchor >= MIN_ANCHOR:
            return ge, [("S", L - right_anchor), ("M", right_anchor)]
        return None
    return a, [("M", L)]


def _mutate(seq: str, err_rate: float, rng) -> str:
    if err_rate <= 0:
        return seq
    arr = dna.encode(seq).copy()
    errs = np.nonzero(rng.random(len(arr)) < err_rate)[0]
    for p in errs:
        arr[p] = (arr[p] + rng.integers(1, 4)) % 4
    return dna.decode(arr)


def simulate(truth: str, gap_spans, n_pairs: int, rng,
             read_len: int = 100, insert: int = 300, std: int = 30,
             err_rate: float = 0.0):
    """Returns (bam_records, left_fastq_entries, right_fastq_entries).

    fastq entries: list of (name, seq_string). err_rate adds uniform
    substitution errors to the read sequences (alignment positions are
    kept — mimicking a mapper tolerating ~1% mismatches).
    """
    T = dna.encode(truth)
    L = len(T)
    bam_records = []
    left_fq, right_fq = [], []
    for i in range(n_pairs):
        ins = int(np.clip(rng.normal(insert, std), 2 * read_len + 2, L - 2))
        p = int(rng.integers(0, L - ins))
        a1, b1 = p, p + read_len
        a2, b2 = p + ins - read_len, p + ins
        seq1 = _mutate(dna.decode(T[a1:b1]), err_rate, rng)
        seq2 = _mutate(dna.decode(dna.revcomp(T[a2:b2])), err_rate, rng)
        name = f"p{i}"
        left_fq.append((name + "/1", seq1))
        right_fq.append((name + "/2", seq2))

        m1 = _align_one(a1, b1, gap_spans)
        m2 = _align_one(a2, b2, gap_spans)
        flag1 = 0x1 | 0x40 | 0x20   # paired, first, mate reverse
        flag2 = 0x1 | 0x80 | 0x10   # paired, second, reverse
        if m1 is None:
            flag1 |= 0x4
            flag2 |= 0x8
        if m2 is None:
            flag2 |= 0x4
            flag1 |= 0x8
        pos1 = m1[0] if m1 else (m2[0] if m2 else None)
        pos2 = m2[0] if m2 else (m1[0] if m1 else None)
        if pos1 is None:
            # both ends unmapped: real mappers keep the pair in the BAM
            # as unplaced flag-12 records (the reference extracts them
            # with `samtools view -f 12`, collect_both_unmapped_reads.py:14-34)
            for nm, fl, sq in ((name, flag1, seq1), (name, flag2, seq2)):
                bam_records.append(dict(
                    name=nm, flag=fl, tid=-1, pos=-1, mapq=0, cigar=[],
                    mtid=-1, mpos=-1, tlen=0, seq=sq))
            continue
        tlen = ins
        rec1 = dict(name=name, flag=flag1, tid=0, pos=pos1, mapq=60 if m1 else 0,
                    cigar=m1[1] if m1 else [], mtid=0, mpos=pos2,
                    tlen=tlen, seq=seq1)
        rec2 = dict(name=name, flag=flag2, tid=0, pos=pos2, mapq=60 if m2 else 0,
                    cigar=m2[1] if m2 else [], mtid=0, mpos=pos1,
                    tlen=-tlen, seq=seq2)
        bam_records.append(rec1)
        bam_records.append(rec2)
    bam_records.sort(key=lambda r: r["pos"])
    return bam_records, left_fq, right_fq


def write_library(tmp_path, prefix, truth, gap_spans, n_pairs, rng, **kw):
    """Write draft-aligned BAM + FASTQ pair; returns (bam, left, right)."""
    recs, lfq, rfq = simulate(truth, gap_spans, n_pairs, rng, **kw)
    bam_path = str(tmp_path / f"{prefix}.bam")
    bam_io.write_bam(bam_path, [("scaf0", len(truth))], recs)
    lp = str(tmp_path / f"{prefix}_1.fastq")
    rp = str(tmp_path / f"{prefix}_2.fastq")
    for path, entries in ((lp, lfq), (rp, rfq)):
        with open(path, "w") as fh:
            for name, seq in entries:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    return bam_path, lp, rp
