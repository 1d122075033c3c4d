"""Minimum end-to-end slice (SURVEY.md §7): draft + reads -> filled
scaffold matching the planted truth."""

import numpy as np
import pytest

from gappadder import dna
from gappadder.config import Config, Library
from gappadder.io import fasta
from gappadder.pipeline import collect, patch, preprocess, run
from gappadder.pipeline.workspace import Workspace

import read_simulator


def _setup(tmp_path, rng, gap_len=150, L=2400, n_pairs=500,
           gap_pos=None, insert=300, std=30, err_rate=0.0,
           min_kmer_count=0):
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    gs = (L // 2 - gap_len // 2) if gap_pos is None else gap_pos
    ge = gs + gap_len
    draft = truth[:gs] + "N" * gap_len + truth[ge:]
    draft_path = str(tmp_path / "draft.fa")
    fasta.write_fasta(draft_path, [("scaf0", draft)])

    bam, lfq, rfq = read_simulator.write_library(
        tmp_path, "lib", truth, [(gs, ge)], n_pairs, rng,
        read_len=100, insert=insert, std=std, err_rate=err_rate)

    cfg = Config(
        draft_genome=draft_path, min_gap_size=50, flank_length=150,
        working_folder=str(tmp_path / "work"),
        kmers=((25, 21), (31, 27)), min_kmer_count=min_kmer_count,
        libraries=(Library(bam=bam, insert_size=insert, std=std,
                           left_fq=lfq, right_fq=rfq),),
        device=__import__("gappadder.config", fromlist=["DeviceParams"])
        .DeviceParams(read_batch=1 << 12))
    return cfg, truth, (gs, ge)


def test_close_single_gap(tmp_path, rng):
    cfg, truth, (gs, ge) = _setup(tmp_path, rng)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)

    gaps = preprocess.run_preprocess(cfg, ws, genome=genome)
    assert len(gaps["start"]) == 1

    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    assert len(rec["gap"]) > 50  # plenty of recruited reads

    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills, f"gap not closed (exts={list(exts)})"
    fill_seq = dna.decode(fills[0][0])
    want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
    assert fill_seq == want, (len(fill_seq), len(want))

    recs = patch.patch_scaffolds(genome, gaps, run.fills_as_codes(fills),
                                 margin=cfg.flank_margin)
    assert dna.decode(recs[0][1]) == truth

    # reference side file: whole winning contigs (pick_contigs.py:566-572)
    ori = fasta.read_fasta(ws.path("picked_seqs.fa_ori.txt"))
    assert len(ori.names) >= 1
    assert ori.names[0] == "0_1_" + fills[0][1]
    assert int(ori.lengths[0]) >= ge - gs        # spans the gap


def test_gap_near_scaffold_edge(tmp_path, rng):
    """Gap 60bp from the scaffold start: the left flank is truncated
    (55bp) — the pick must still anchor and close or extend."""
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, gap_len=120, L=2200,
                                  n_pairs=520, gap_pos=60)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    gaps = preprocess.run_preprocess(cfg, ws, genome=genome)
    assert int(gaps["flank_left_len"][0]) == 60 - cfg.flank_margin
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills or 0 in exts
    if 0 in fills:
        want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
        assert dna.decode(fills[0][0]) == want


def test_close_gap_with_sequencing_errors(tmp_path, rng):
    """0.5% substitution errors; the adaptive k-mer count filter +
    DBG tip clipping must still recover the exact gap sequence."""
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, n_pairs=700,
                                  err_rate=0.005, min_kmer_count=-1)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills, f"noisy gap not closed (exts={list(exts)})"
    fill_seq = dna.decode(fills[0][0])
    want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
    assert fill_seq == want


def test_close_large_gap_needs_rescue(tmp_path, rng):
    """A gap wider than mate reach from the edges: its interior is
    covered only by both-ends-unmapped pairs, so closing it exercises
    the rescue + round-2 path."""
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, gap_len=450, L=4000,
                                  n_pairs=1400)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills, f"large gap not closed (exts={list(exts)})"
    fill_seq = dna.decode(fills[0][0])
    want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
    assert fill_seq == want


def test_close_gap_over_2kb(tmp_path, rng):
    """VERDICT r1 #5: a >2 kb gap fill was structurally impossible under
    the old max_contig_len=2048 cap. With auto bounds it must close
    bit-exact."""
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, gap_len=2600, L=8000,
                                  n_pairs=4000, insert=700, std=60)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills, f"2.6kb gap not closed (exts={list(exts)})"
    fill_seq = dna.decode(fills[0][0])
    want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
    assert fill_seq == want
    assert len(fill_seq) > 2048  # genuinely past the old cap


def test_reads_per_gap_cap_warns(tmp_path, rng):
    """A positive max_reads_per_gap must truncate LOUDLY, never
    silently."""
    from gappadder.utils import log as gtlog
    import dataclasses
    gtlog.reset_cap_events()
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, n_pairs=600)
    cfg = dataclasses.replace(cfg, max_reads_per_gap=64)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    run.run_assembly_and_pick(cfg, ws, rec=rec, readsets=readsets,
                              genome=genome)
    assert gtlog.cap_events("reads_per_gap_truncated") > 0


def test_fixed_kmer_cap_warns(tmp_path, rng):
    """A positive max_distinct_kmers that saturates must warn (the old
    behavior dropped lexicographically-largest k-mers silently)."""
    from gappadder.utils import log as gtlog
    import dataclasses
    gtlog.reset_cap_events()
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, n_pairs=600)
    cfg = dataclasses.replace(cfg, max_distinct_kmers=128)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    run.run_assembly_and_pick(cfg, ws, rec=rec, readsets=readsets,
                              genome=genome)
    assert gtlog.cap_events("kmer_table_truncated") > 0
