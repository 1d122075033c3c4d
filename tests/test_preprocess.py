import os

import numpy as np

from gappadder import dna
from gappadder.config import Config
from gappadder.io import fasta
from gappadder.pipeline import preprocess
from gappadder.pipeline.workspace import Workspace


def _write_draft(tmp_path):
    scaf0 = "ACGTACGTACGTACGTACGT" + "N" * 12 + "TGCATGCATGCATGCATGCA"
    scaf1 = "AAAACCCC" + "N" * 20 + "GGGGTTTT" + "N" * 6 + "CCAACCAA"
    path = str(tmp_path / "draft.fa")
    fasta.write_fasta(path, [("s0", scaf0), ("s1", scaf1)])
    return path, [scaf0, scaf1]


def test_run_preprocess_outputs(tmp_path):
    draft, seqs = _write_draft(tmp_path)
    cfg = Config(draft_genome=draft, min_gap_size=5, flank_length=15,
                 working_folder=str(tmp_path / "work"))
    ws = Workspace(cfg.workdir)
    table = preprocess.run_preprocess(cfg, ws, write_parity_files=True)

    assert len(table["start"]) == 3
    ids = preprocess.gap_ids(table)
    assert ids == ["0_1", "1_1", "1_2"]

    # gap_positions.txt reference format
    lines = open(ws.path("gap_positions.txt")).read().splitlines()
    assert lines[0] == "20 32 12 s0"
    assert lines[1] == "8 28 20 s1"

    # flank fasta parity: left = seq[start-flank:start-5], right = seq[end+5:end+flank]
    recs = dict(fasta.iter_fasta(ws.path("flank_regions/0_1.fa")))
    assert dna.decode(recs["0_1_left"]) == seqs[0][20 - 15: 20 - 5]
    assert dna.decode(recs["0_1_right"]) == seqs[0][32 + 5: 32 + 15]

    # checkpoint resume works
    assert ws.has_arrays("gaps")
    loaded = ws.load_arrays("gaps")
    np.testing.assert_array_equal(loaded["start"], table["start"])
    info = ws.stage_info("preprocess")
    assert info["num_gaps"] == 3


def test_preprocess_no_gaps(tmp_path):
    path = str(tmp_path / "draft.fa")
    fasta.write_fasta(path, [("s0", "ACGT" * 10)])
    cfg = Config(draft_genome=path, working_folder=str(tmp_path / "w"))
    table = preprocess.run_preprocess(cfg, Workspace(cfg.workdir))
    assert len(table["start"]) == 0


def test_write_fai(tmp_path):
    path = str(tmp_path / "g.fa")
    fasta.write_fasta(path, [("s0", "ACGT" * 30), ("s1", "TT")], width=50)
    fai = fasta.write_fai(path)
    lines = [l.split("\t") for l in open(fai).read().splitlines()]
    assert lines[0][0] == "s0" and int(lines[0][1]) == 120
    assert int(lines[0][3]) == 50 and int(lines[0][4]) == 51
    assert lines[1][0] == "s1" and int(lines[1][1]) == 2
    # offsets point at the first base
    data = open(path, "rb").read()
    assert data[int(lines[0][2]):int(lines[0][2]) + 4] == b"ACGT"
    assert data[int(lines[1][2]):int(lines[1][2]) + 2] == b"TT"
