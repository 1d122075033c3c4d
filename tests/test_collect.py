import numpy as np
import pytest

from gappadder.config import Config, Library
from gappadder.io import bam as bam_io
from gappadder.io import fasta, fastq
from gappadder.pipeline import collect, preprocess
from gappadder.pipeline.workspace import Workspace

import reference_oracle as oracle


SCAFFOLDS = {
    "s0": [(400, 520), (900, 1020)],   # gap (start,end) 0-based
    "s1": [(300, 450)],
    "s2": [],
}
SCAF_LEN = {"s0": 1600, "s1": 900, "s2": 500}


def _make_genome(tmp_path):
    recs = []
    rng = np.random.default_rng(7)
    for name in ("s0", "s1", "s2"):
        L = SCAF_LEN[name]
        s = np.array(list("ACGT"))[rng.integers(0, 4, L)]
        for (a, b) in SCAFFOLDS[name]:
            s[a:b] = "N"
        recs.append((name, "".join(s)))
    path = str(tmp_path / "draft.fa")
    fasta.write_fasta(path, recs)
    return path


def _gen_records(rng, n=800):
    """Random alignment records exercising all the branches."""
    names = list(SCAF_LEN)
    recs = []
    for i in range(n):
        scaf = names[rng.integers(0, 3)]
        L = SCAF_LEN[scaf]
        pos1 = int(rng.integers(1, L + 1))
        first = bool(rng.integers(0, 2))
        flag = 0x1 | (0x40 if first else 0x80)
        kind = rng.integers(0, 5)
        self_unmapped = kind == 4
        mate_unmapped = kind == 3
        if self_unmapped:
            flag |= 0x4
        if mate_unmapped:
            flag |= 0x8
        mapq = int(rng.choice([0, 0, 20, 30, 60]))
        if self_unmapped:
            mapq = 0
        lclip = int(rng.choice([0, 0, 0, 5, 20]))
        rclip = int(rng.choice([0, 0, 0, 5, 20]))
        if self_unmapped:
            lclip = rclip = 0
        cross = kind == 2
        if cross:  # in BAM mtid==tid IS the "=" case; pick a different one
            mate_scaf = names[(names.index(scaf) + 1 +
                               int(rng.integers(0, 2))) % 3]
        else:
            mate_scaf = scaf
        mate_ref_same = mate_scaf == scaf
        mpos1 = int(rng.integers(1, SCAF_LEN[mate_scaf] + 1))
        tlen = int(rng.choice([100, 250, 900, 1500, 40]) *
                   (1 if rng.integers(0, 2) else -1))
        recs.append(dict(name=f"r{i}", flag=flag, scaffold=scaf, pos1=pos1,
                         mapq=mapq, mate_ref_same=mate_ref_same,
                         mate_scaffold=mate_scaf, mate_pos1=mpos1,
                         tlen=tlen, lclip=lclip, rclip=rclip))
    return recs


def _oracle_run(recs, insert_size, std, clip_dist=60, anchor_mapq=30):
    scaffold_index = {n: i for i, n in enumerate(SCAF_LEN)}
    by_scaf = {n: [r for r in recs if r["scaffold"] == n] for n in SCAF_LEN}
    lists = {}
    for name in SCAF_LEN:
        lists[name] = oracle.classify_scaffold(
            by_scaf[name], SCAFFOLDS[name], insert_size=insert_size,
            std=std, dist_clip=clip_dist, anchor_mapq=anchor_mapq)
    inverted = oracle.invert_discordant(lists, scaffold_index)
    low = oracle.lowmapq_pass(by_scaf, inverted, scaffold_index,
                              list(SCAF_LEN))
    union = oracle.union_recruits(lists, low, scaffold_index)
    hq = oracle.hq_recruits(lists, scaffold_index)
    return union, hq


def _pipeline_run(tmp_path, recs, insert_size, std, clip_dist=60,
                  anchor_mapq=30):
    draft = _make_genome(tmp_path)
    # FASTQ: every read name exists on both sides
    rng = np.random.default_rng(1)
    for side in ("L", "R"):
        with open(tmp_path / f"reads_{side}.fastq", "w") as fh:
            for i in range(len(recs)):
                s = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)])
                fh.write(f"@r{i}/{1 if side == 'L' else 2}\n{s}\n+\n"
                         f"{'I' * 30}\n")
    # BAM
    refs = [(n, SCAF_LEN[n]) for n in SCAF_LEN]
    ridx = {n: i for i, n in enumerate(SCAF_LEN)}
    bam_records = []
    for r in recs:
        cigar = []
        if r["lclip"]:
            cigar.append(("S", r["lclip"]))
        cigar.append(("M", 30))
        if r["rclip"]:
            cigar.append(("S", r["rclip"]))
        if r["flag"] & 0x4:
            cigar = []
        bam_records.append(dict(
            name=r["name"], flag=r["flag"], tid=ridx[r["scaffold"]],
            pos=r["pos1"] - 1, mapq=r["mapq"], cigar=cigar,
            mtid=ridx[r["mate_scaffold"]], mpos=r["mate_pos1"] - 1,
            tlen=r["tlen"]))
    bam_path = str(tmp_path / "lib.bam")
    bam_io.write_bam(bam_path, refs, bam_records)

    cfg = Config(
        draft_genome=draft, min_gap_size=50, flank_length=100,
        clip_dist=clip_dist, anchor_mapq=anchor_mapq,
        working_folder=str(tmp_path / "work"),
        libraries=(Library(bam=bam_path, insert_size=insert_size, std=std,
                           left_fq=str(tmp_path / "reads_L.fastq"),
                           right_fq=str(tmp_path / "reads_R.fastq")),))
    ws = Workspace(cfg.workdir)
    gaps = preprocess.run_preprocess(cfg, ws)
    rec, readsets = collect.run_collect(cfg, ws)
    return cfg, ws, gaps, rec, readsets


def _rec_to_maps(gaps, rec, readsets):
    """pipeline arrays -> ({name: {(scafidx, gapnum)}}, left/right)."""
    left_map, right_map = {}, {}
    for g, side, li, row, hq in zip(rec["gap"], rec["side"], rec["lib"],
                                    rec["row"], rec["hq"]):
        rs = readsets[li][side]
        name = rs.get_name(row).decode()
        key = (int(gaps["scaffold"][g]), int(gaps["number"][g]))
        mp = left_map if side == 0 else right_map
        mp.setdefault(name, set()).add(key)
    return left_map, right_map


@pytest.mark.parametrize("insert_size,std", [(900, 100), (300, 50)])
def test_collect_parity_with_oracle(tmp_path, insert_size, std):
    rng = np.random.default_rng(3)
    recs = _gen_records(rng)
    (oleft, oright), (ohl, ohr) = _oracle_run(recs, insert_size, std)
    cfg, ws, gaps, rec, readsets = _pipeline_run(tmp_path, recs,
                                                 insert_size, std)
    # sanity: gap table matches the planted gaps
    assert len(gaps["start"]) == 3
    pleft, pright = _rec_to_maps(gaps, rec, readsets)
    assert pleft == oleft
    assert pright == oright
    # HQ subset parity
    hq_rec = {k: v[rec["hq"]] for k, v in rec.items()}
    phl, phr = _rec_to_maps(gaps, hq_rec, readsets)
    assert phl == ohl
    assert phr == ohr


def test_device_union_matches_host(tmp_path):
    """The device-side dedup + hash-join (ops/recruit) must produce the
    same recruitment set as the host numpy oracle path."""
    from gappadder.pipeline.collect import collect_library, \
        read_bam_any, read_fastq_any
    from gappadder.pipeline.workspace import Workspace
    rng = np.random.default_rng(3)
    recs = _gen_records(rng)
    cfg, ws, gaps, rec, readsets = _pipeline_run(tmp_path, recs, 900, 100)
    lib = cfg.libraries[0]
    aln = read_bam_any(lib.bam)
    left = read_fastq_any(lib.left_fq)
    right = read_fastq_any(lib.right_fq)
    scaffold_names = ws.load_json("scaffold_names")
    host = collect_library(cfg, lib, gaps, scaffold_names, aln, left,
                           right, use_device_union=False)
    dev = collect_library(cfg, lib, gaps, scaffold_names, aln, left,
                          right, use_device_union=True)
    h = set(zip(host["gap"], host["side"], host["row"], host["hq"]))
    d = set(zip(dev["gap"], dev["side"], dev["row"], dev["hq"]))
    assert h == d
    assert len(host["gap"]) == len(dev["gap"])


def test_mesh_sharded_collect_matches(tmp_path):
    """collect_library under an 8-device mesh == single-device result
    (the production classify running sharded, not just the dryrun)."""
    import jax
    from gappadder.parallel.mesh import make_mesh
    from gappadder.pipeline.collect import collect_library, \
        read_bam_any, read_fastq_any
    rng = np.random.default_rng(3)
    recs = _gen_records(rng)
    cfg, ws, gaps, rec, readsets = _pipeline_run(tmp_path, recs, 300, 50)
    lib = cfg.libraries[0]
    aln = read_bam_any(lib.bam)
    left = read_fastq_any(lib.left_fq)
    right = read_fastq_any(lib.right_fq)
    names = ws.load_json("scaffold_names")
    mesh = make_mesh(devices=jax.devices()[:8])
    single = collect_library(cfg, lib, gaps, names, aln, left, right)
    sharded = collect_library(cfg, lib, gaps, names, aln, left, right,
                              mesh=mesh)
    for k in ("gap", "side", "row", "hq"):
        np.testing.assert_array_equal(single[k], sharded[k], k)


def test_mesh_ecap_regrow_with_inflight_batches(tmp_path):
    """ADVICE r4 (medium): an ecap overflow regrow must not corrupt
    batches already in the in-flight pipeline — they carry the OLD
    [n_shards*(old_ecap+1), 7] packed layout and must be parsed with
    the stride they were dispatched with. Forces overflow by starting
    with a tiny ecap and a small read batch so several batches are in
    flight when the regrow happens, on an 8-shard mesh (where the bug
    silently corrupted shard >= 1 segments)."""
    import dataclasses
    import jax
    from gappadder.parallel.mesh import make_mesh
    from gappadder.pipeline.collect import collect_library, \
        read_bam_any, read_fastq_any
    rng = np.random.default_rng(3)
    recs = _gen_records(rng)
    cfg, ws, gaps, rec, readsets = _pipeline_run(tmp_path, recs, 300, 50)
    cfg = dataclasses.replace(
        cfg, device=dataclasses.replace(cfg.device, read_batch=64))
    lib = cfg.libraries[0]
    aln = read_bam_any(lib.bam)
    left = read_fastq_any(lib.left_fq)
    right = read_fastq_any(lib.right_fq)
    names = ws.load_json("scaffold_names")
    mesh = make_mesh(devices=jax.devices()[:8])
    ref = collect_library(cfg, lib, gaps, names, aln, left, right,
                          mesh=mesh)
    grown = collect_library(cfg, lib, gaps, names, aln, left, right,
                            mesh=mesh, initial_ecap=4)
    for k in ("gap", "side", "row", "hq"):
        np.testing.assert_array_equal(ref[k], grown[k], k)


def test_bam_roundtrip(tmp_path):
    refs = [("c1", 1000), ("c2", 500)]
    recs = [
        dict(name="a", flag=0x41, tid=0, pos=10, mapq=60,
             cigar=[("S", 5), ("M", 20), ("S", 3)], mtid=1, mpos=99,
             tlen=150, seq="ACGTACGTACGTACGTACGTACGTACGT"),
        dict(name="b", flag=0x85, tid=1, pos=0, mapq=0, cigar=[],
             mtid=-1, mpos=-1, tlen=0),
    ]
    path = str(tmp_path / "t.bam")
    bam_io.write_bam(path, refs, recs)
    a = bam_io.read_bam(path, keep_names=True)
    assert a.refs == ["c1", "c2"]
    assert a.n == 2
    assert list(a.pos) == [10, 0]
    assert list(a.lclip) == [5, 0]
    assert list(a.rclip) == [3, 0]
    assert list(a.nmatch) == [20, 0]
    assert a.names == [b"a", b"b"]
    assert list(a.flag) == [0x41, 0x85]
    assert list(a.tlen) == [150, 0]
