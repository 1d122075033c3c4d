"""End-to-end: multiple scaffolds, multiple gaps, two libraries
(short-insert PE + longer-insert), exercising insert-size-aware
windows and cross-library merge (BASELINE.md config 4 shape)."""

import numpy as np

from gappadder import dna
from gappadder.config import Config, Library, DeviceParams
from gappadder.io import bam as bam_io, fasta
from gappadder.pipeline import collect, patch, preprocess, run
from gappadder.pipeline.workspace import Workspace

import read_simulator


def _write_two_scaffold_library(tmp_path, prefix, truths, gap_spans_per_scaf,
                                n_pairs, rng, insert, std):
    """Simulate one library over two scaffolds into one BAM + FASTQs."""
    all_recs = []
    lfq, rfq = [], []
    for si, (truth, spans) in enumerate(zip(truths, gap_spans_per_scaf)):
        recs, lf, rf = read_simulator.simulate(
            truth, spans, n_pairs, rng, read_len=100, insert=insert, std=std)
        for r in recs:
            r["tid"] = si
            r["mtid"] = si
            r["name"] = f"s{si}{prefix}_" + r["name"]
        all_recs += recs
        lfq += [(f"s{si}{prefix}_{n}", s) for n, s in lf]
        rfq += [(f"s{si}{prefix}_{n}", s) for n, s in rf]
    all_recs.sort(key=lambda r: (r["tid"], r["pos"]))
    bam_path = str(tmp_path / f"{prefix}.bam")
    bam_io.write_bam(bam_path, [(f"scaf{i}", len(t))
                                for i, t in enumerate(truths)], all_recs)
    lp = str(tmp_path / f"{prefix}_1.fastq")
    rp = str(tmp_path / f"{prefix}_2.fastq")
    for path, entries in ((lp, lfq), (rp, rfq)):
        with open(path, "w") as fh:
            for name, seq in entries:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    return bam_path, lp, rp


def test_multi_scaffold_two_libraries(tmp_path, rng):
    L0, L1 = 2600, 2200
    t0 = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L0)])
    t1 = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L1)])
    spans0 = [(700, 850), (1700, 1820)]
    spans1 = [(1000, 1160)]
    d0 = list(t0)
    for a, b in spans0:
        d0[a:b] = "N" * (b - a)
    d1 = list(t1)
    for a, b in spans1:
        d1[a:b] = "N" * (b - a)
    draft_path = str(tmp_path / "draft.fa")
    fasta.write_fasta(draft_path, [("scaf0", "".join(d0)),
                                   ("scaf1", "".join(d1))])

    bamA, lA, rA = _write_two_scaffold_library(
        tmp_path, "A", [t0, t1], [spans0, spans1], 650, rng, 300, 30)
    bamB, lB, rB = _write_two_scaffold_library(
        tmp_path, "B", [t0, t1], [spans0, spans1], 450, rng, 800, 80)

    cfg = Config(
        draft_genome=draft_path, min_gap_size=50, flank_length=150,
        working_folder=str(tmp_path / "work"),
        kmers=((25, 21), (31, 27)),
        libraries=(
            Library(bam=bamA, insert_size=300, std=30, left_fq=lA,
                    right_fq=rA),
            Library(bam=bamB, insert_size=800, std=80, left_fq=lB,
                    right_fq=rB),
        ),
        device=DeviceParams(read_batch=1 << 12))

    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    gaps = preprocess.run_preprocess(cfg, ws, genome=genome)
    assert len(gaps["start"]) == 3
    assert list(gaps["scaffold"]) == [0, 0, 1]

    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    assert set(np.unique(rec["lib"])) == {0, 1}

    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert set(fills) == {0, 1, 2}, (list(fills), list(exts))
    recs = patch.patch_scaffolds(genome, gaps, run.fills_as_codes(fills),
                                 margin=cfg.flank_margin)
    assert dna.decode(recs[0][1]) == t0
    assert dna.decode(recs[1][1]) == t1
