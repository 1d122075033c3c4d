"""CLI smoke test: the reference-compatible command surface."""

import json

import numpy as np
import pytest

from gappadder import dna
from gappadder.io import fasta

import read_simulator


def test_cli_all_and_resume(tmp_path, rng, capsys):
    from gappadder.cli import main

    L, gl = 2000, 140
    truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
    gs = 900
    ge = gs + gl
    draft = truth[:gs] + "N" * gl + truth[ge:]
    fasta.write_fasta(tmp_path / "draft.fa", [("scaf0", draft)])
    read_simulator.write_library(tmp_path, "lib", truth, [(gs, ge)],
                                 420, rng)
    cfg = {
        "draft_genome": {"fa": "draft.fa"},
        "alignments": [{"bam": "lib.bam", "is": 300, "std": 30}],
        "raw_reads": [{"left": "lib_1.fastq", "right": "lib_2.fastq"}],
        "kmer_length": [{"k": 25, "k_velvet": [{"k": 21}]}],
        "parameters": {"working_folder": "work", "min_gap_size": 50,
                       "flank_length": 150, "nthreads": 1, "verbose": 0},
        "device": {"read_batch": 4096},
    }
    (tmp_path / "work").mkdir()
    with open(tmp_path / "config.json", "w") as fh:
        json.dump(cfg, fh)

    rc = main(["-c", "All", "-g", str(tmp_path / "config.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "gaps closed" in out

    filled = dict(fasta.iter_fasta(tmp_path / "work/filled_scaffolds.fa"))
    assert dna.decode(filled["scaf0"]) == truth

    # merge provenance file (ContigsMerger .merge.info equivalent)
    # exists; any lines follow '<gap_id>\tNEW_CONTIG_MERGE_<i>  ...'
    minfo = (tmp_path / "work/merge_info.txt").read_text()
    for ln in minfo.splitlines():
        gid, rest = ln.split("\t", 1)
        assert gid == "0_1" and rest.startswith("NEW_CONTIG_MERGE_")

    # resume: stages skip as up-to-date
    rc = main(["-c", "All", "-g", str(tmp_path / "config.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("up-to-date") >= 3

    # Evaluate against the finished (truth) genome
    fasta.write_fasta(tmp_path / "finished.fa", [("t0", truth)])
    rc = main(["-c", "Evaluate", "-g", str(tmp_path / "config.json"),
               "--finished", str(tmp_path / "finished.fa")])
    assert rc == 0
    hits = open(tmp_path / "work/hit_list.txt").read().split()
    assert hits == ["0_1"]
    lens = open(tmp_path / "work/closed_gap_length.txt").read().split()
    assert len(lens) == 1

    # Clean removes the workspace
    rc = main(["-c", "Clean", "-g", str(tmp_path / "config.json")])
    assert rc == 0
    assert not (tmp_path / "work").exists()


def test_example_config_parses():
    """examples/configuration.json (the user-facing sample, reference
    schema) parses, incl. a bam-less self-mapping library."""
    import json
    import os
    from gappadder.config import config_from_dict
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "examples", "configuration.json")
    with open(path) as fh:
        cfg = config_from_dict(json.load(fh),
                               base_dir=os.path.dirname(path))
    assert len(cfg.libraries) == 2
    assert cfg.libraries[0].bam.endswith("lib300.sort.bam")
    assert cfg.libraries[1].bam is None           # self-mapping mode
    assert cfg.kmers == ((30, 29), (30, 27), (40, 39), (40, 37))
