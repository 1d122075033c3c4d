"""Whole pipeline with device.mesh_shape=(8,1): collect + assembly run
sharded over the virtual mesh and must still close the gap bit-exact."""

import numpy as np

from gappadder import dna
from gappadder.config import Config, Library, DeviceParams
from gappadder.io import fasta
from gappadder.pipeline import collect, preprocess, run
from gappadder.pipeline.workspace import Workspace

import read_simulator


def test_pipeline_with_mesh(tmp_path, rng):
    L, gl = 2400, 150
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    gs = L // 2
    ge = gs + gl
    draft = truth[:gs] + "N" * gl + truth[ge:]
    draft_path = str(tmp_path / "draft.fa")
    fasta.write_fasta(draft_path, [("scaf0", draft)])
    bam, lfq, rfq = read_simulator.write_library(
        tmp_path, "lib", truth, [(gs, ge)], 500, rng)

    cfg = Config(
        draft_genome=draft_path, min_gap_size=50, flank_length=150,
        working_folder=str(tmp_path / "work"), kmers=((25, 21),),
        libraries=(Library(bam=bam, insert_size=300, std=30,
                           left_fq=lfq, right_fq=rfq),),
        device=DeviceParams(read_batch=1 << 12,
                            mesh_shape=(4, 2), mesh_axes=("dp", "sp")))
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    gaps = preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    assert len(rec["gap"]) > 20
    fills, exts, _ = run.run_assembly_and_pick(cfg, ws, rec=rec,
                                               readsets=readsets,
                                               genome=genome)
    assert 0 in fills
    want = truth[gs - cfg.flank_margin: ge + cfg.flank_margin]
    assert dna.decode(fills[0][0]) == want
