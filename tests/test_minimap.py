"""Minimizer mapper (ops/minimap.py): roundtrips, clipping, mapq, the
no-BAM self-mapping collect mode, and full-pipeline closure without an
external aligner — a capability the reference lacks (it REQUIRES
pre-aligned `bwa mem` BAMs, /root/reference/README.md:46-84).
"""

import numpy as np
import pytest

from gappadder import dna
from gappadder.io import fasta, fastq
from gappadder.ops import minimap


def make_genome(rng, lengths=(3000, 2000)):
    seqs = [rng.integers(0, 4, L).astype(np.int8) for L in lengths]
    return fasta.Genome(
        seq=np.concatenate(sum(([s, np.array([dna.SEP], np.int8)]
                                for s in seqs), [])[:-1]),
        offsets=np.cumsum([0] + [L + 1 for L in lengths[:-1]]).astype(
            np.int64),
        lengths=np.asarray(lengths, np.int64),
        names=[f"scaf{i}" for i in range(len(lengths))])


def pack(reads):
    Lmax = max(len(r) for r in reads)
    seq = np.full((len(reads), Lmax), dna.N, np.int8)
    for i, r in enumerate(reads):
        seq[i, :len(r)] = r
    return seq, np.asarray([len(r) for r in reads], np.int32)


def test_roundtrip_fwd_rev_unmapped(rng):
    g = make_genome(rng)
    idx = minimap.build_index(g)
    starts = [100, 700, 1500, 2800]     # 2800 is on scaffold 1
    reads, want = [], []
    for st in starts:
        reads.append(g.seq[st:st + 100].copy())
        want.append((st, 0))
        reads.append(dna.revcomp(g.seq[st + 7:st + 107]))
        want.append((st + 7, 1))
    reads.append(rng.integers(0, 4, 100).astype(np.int8))  # random junk
    want.append((-1, 0))
    seq, ln = pack(reads)
    p = minimap.map_reads(g, idx, seq, ln)
    for i, (gs, strand) in enumerate(want):
        assert p.gstart[i] == gs, (i, p.gstart[i], gs)
        if gs >= 0:
            assert p.strand[i] == strand
            assert p.mapq[i] == 60
            assert p.nmatch[i] == 100
            assert p.lclip[i] == 0 and p.rclip[i] == 0
        else:
            assert p.mapq[i] == 0


def test_index_chunk_size_invariance(rng):
    """Index contents must not depend on the build chunk size
    (boundary-window minimizers used to be silently dropped)."""
    g = make_genome(rng, lengths=(5000,))
    full = minimap.build_index(g, chunk=1 << 30)
    for chunk in (256, 1000, 4096):
        part = minimap.build_index(g, chunk=chunk)
        assert np.array_equal(part.keys, full.keys), chunk
        assert np.array_equal(part.pos, full.pos), chunk
        assert np.array_equal(part.strand, full.strand), chunk


def test_seed_wobble_keeps_mapq60(rng):
    """A read with a 1-base deletion spreads its seeds over two
    adjacent diagonals; the neighbor bin is part of the winning group
    and must NOT count as a second-best hit (mapq stays 60)."""
    g = make_genome(rng, lengths=(4000,))
    idx = minimap.build_index(g)
    st = 900
    read = np.concatenate([g.seq[st:st + 50], g.seq[st + 51:st + 101]])
    seq, ln = pack([read])
    p = minimap.map_reads(g, idx, seq, ln)
    assert p.gstart[0] >= 0
    assert p.mapq[0] == 60, int(p.mapq[0])


def test_gap_edge_soft_clip(rng):
    """Read overlapping an N-run gets its in-gap tail soft-clipped at
    the exact gap boundary (bwa-like Kadane clip)."""
    g = make_genome(rng, lengths=(3000,))
    g.seq[1000:1200] = dna.N                  # plant a gap
    idx = minimap.build_index(g)
    r1 = g.seq[940:1040].copy()               # 60 anchor + 40 into gap
    r1[60:] = rng.integers(0, 4, 40)          # true gap bases, not N
    r2 = g.seq[1160:1260].copy()              # 40 in gap + 60 anchor
    r2[:40] = rng.integers(0, 4, 40)
    seq, ln = pack([r1, r2])
    p = minimap.map_reads(g, idx, seq, ln)
    assert p.gstart[0] == 940 and p.lclip[0] == 0 and p.rclip[0] == 40
    assert p.gstart[1] == 1200 and p.lclip[1] == 40 and p.rclip[1] == 0
    assert p.nmatch[0] == 60 and p.nmatch[1] == 60


def test_repeat_read_gets_mapq0(rng):
    g = make_genome(rng, lengths=(4000,))
    g.seq[2000:2300] = g.seq[500:800]          # exact 300bp repeat
    idx = minimap.build_index(g)
    seq, ln = pack([g.seq[600:700].copy()])    # inside the repeat
    p = minimap.map_reads(g, idx, seq, ln)
    assert p.gstart[0] >= 0                    # placed somewhere...
    assert p.mapq[0] == 0                      # ...but flagged repeat


def _readset(entries):
    names = [n.encode() for n, _ in entries]
    return fastq.ReadSet(
        seq=pack([s for _, s in entries])[0],
        length=pack([s for _, s in entries])[1],
        qual=np.full(pack([s for _, s in entries])[0].shape, 73, np.uint8),
        name_hash=fastq._fnv1a_batch(names), names=names)


def test_map_library_pairing(rng):
    """Flags/tlen/mate fields follow the BAM conventions classify
    consumes (0x40/0x4/0x8, mate coords, signed tlen)."""
    g = make_genome(rng, lengths=(3000,))
    idx = minimap.build_index(g)
    # FR proper pair: left fwd @500, right rev ending @800
    left = _readset([("p0", g.seq[500:600].copy()),
                     ("p1", rng.integers(0, 4, 100).astype(np.int8))])
    right = _readset([("p0", dna.revcomp(g.seq[700:800])),
                      ("p1", dna.revcomp(g.seq[1500:1600]))])
    aln = minimap.map_library(g, idx, left, right)
    assert aln.n == 4
    l0, r0, l1, r1 = aln.flag[0], aln.flag[2], aln.flag[1], aln.flag[3]
    # pair 0: proper FR
    assert l0 & 0x1 and l0 & 0x40 and not l0 & 0x4 and not l0 & 0x8
    assert l0 & 0x2 and l0 & 0x20 and not l0 & 0x10
    assert r0 & 0x80 and r0 & 0x10 and not r0 & 0x20
    assert aln.pos[0] == 500 and aln.pos[2] == 700
    assert aln.tlen[0] == 300 and aln.tlen[2] == -300
    assert aln.mpos[0] == 700 and aln.mpos[2] == 500
    # pair 1: left unmapped, placed at the mapped mate's coords
    assert l1 & 0x4 and not l1 & 0x8
    assert r1 & 0x8 and not r1 & 0x4
    assert aln.pos[1] == aln.pos[3] == 1500
    assert aln.tid[1] == aln.tid[3] == 0
    assert aln.mapq[1] == 0


def test_selfmap_recruit_overlap(tmp_path, rng):
    """Self-mapping collect vs the BAM path on the same library: the
    recruit sets must agree almost exactly (the mapper uses bwa's
    T=30 score threshold; the simulator's BAM keeps 20bp anchors, so
    the BAM path may recruit a few extra short-anchor clips)."""
    from test_end_to_end import _setup
    import dataclasses
    from gappadder.pipeline import collect, preprocess
    from gappadder.pipeline.workspace import Workspace

    cfg, truth, (gs, ge) = _setup(tmp_path, rng)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    gaps = preprocess.run_preprocess(cfg, ws, genome=genome)
    scaffold_names = ws.load_json("scaffold_names")

    lib = cfg.libraries[0]
    left = collect.read_fastq_any(lib.left_fq)
    right = collect.read_fastq_any(lib.right_fq)

    aln_bam = collect.read_bam_any(lib.bam)
    rec_bam = collect.collect_library(cfg, lib, gaps, scaffold_names,
                                      aln_bam, left, right)
    idx = minimap.build_index(genome)
    aln_map = minimap.map_library(genome, idx, left, right)
    rec_map = collect.collect_library(cfg, lib, gaps, scaffold_names,
                                      aln_map, left, right)

    def keyset(rec):
        return set(zip(rec["gap"].tolist(), rec["side"].tolist(),
                       rec["row"].tolist()))

    kb, km = keyset(rec_bam), keyset(rec_map)
    inter = len(kb & km)
    assert inter / max(len(kb), 1) > 0.9, (len(kb), len(km), inter)
    assert inter / max(len(km), 1) > 0.9, (len(kb), len(km), inter)


def test_selfmap_full_pipeline_closes_gap(tmp_path, rng):
    """bam=None end to end: preprocess -> self-map collect ->
    assemble -> pick closes the planted gap bit-exactly."""
    import dataclasses
    from test_end_to_end import _setup
    from gappadder.pipeline import collect, preprocess, run
    from gappadder.pipeline.workspace import Workspace

    cfg, truth, (gs, ge) = _setup(tmp_path, rng)
    lib = dataclasses.replace(cfg.libraries[0], bam=None)
    cfg = dataclasses.replace(cfg, libraries=(lib,))
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    assert len(rec["gap"]) > 50
    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills, f"gap not closed (exts={list(exts)})"
    want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
    assert dna.decode(fills[0][0]) == want
