"""Fused dataplane parity: the device assembly path (pipeline/fused.py,
the benchmarked slice blocks routed through the shipped Assembly
stage) must produce BIT-IDENTICAL contigs and picks to the host-glued
oracle path (_pad_batch + assemble_gap_batch), on single- and
multi-shard meshes — VERDICT r2 missing #3's done criterion.
"""

import dataclasses

import numpy as np

from gappadder.config import DeviceParams
from gappadder.io import fasta
from gappadder.pipeline import collect, preprocess, run
from gappadder.pipeline.workspace import Workspace

from test_end_to_end import _setup


def _run(cfg, tag):
    cfg = dataclasses.replace(
        cfg, working_folder=cfg.working_folder + "_" + tag)
    ws = Workspace(cfg.workdir)
    genome = fasta.read_fasta(cfg.draft_genome)
    preprocess.run_preprocess(cfg, ws, genome=genome)
    rec, readsets = collect.run_collect(cfg, ws, genome=genome)
    fills, exts, store = run.run_assembly_and_pick(
        cfg, ws, rec=rec, readsets=readsets, genome=genome)
    with open(ws.path("picked_seqs.fa"), "rb") as f:
        picked = f.read()
    return fills, exts, store, picked


def _store_view(store):
    out = {}
    for g, (seq, lens, n, names) in store.items():
        out[g] = [(names[i], np.asarray(seq[i][:int(lens[i])]).tolist())
                  for i in range(int(n))]
    return out


def test_fused_matches_host_path(tmp_path, rng):
    cfg, truth, (gs, ge) = _setup(tmp_path, rng, n_pairs=600,
                                  err_rate=0.002)
    host = _run(dataclasses.replace(
        cfg, device=dataclasses.replace(cfg.device, fused=False)), "host")
    fused1 = _run(dataclasses.replace(
        cfg, device=dataclasses.replace(cfg.device, fused=True)), "fused1")
    fused8 = _run(dataclasses.replace(
        cfg, device=dataclasses.replace(
            cfg.device, fused=True, mesh_shape=(8,), gap_batch=8)), "fused8")

    for got, name in ((fused1, "fused-1shard"), (fused8, "fused-8shard")):
        assert _store_view(got[2]) == _store_view(host[2]), name
        assert got[0].keys() == host[0].keys(), name
        for g in host[0]:
            assert (np.asarray(got[0][g][0]) ==
                    np.asarray(host[0][g][0])).all(), (name, g)
            assert got[0][g][1] == host[0][g][1], (name, g)
        assert got[3] == host[3], name         # picked_seqs.fa bytes
