"""Collect stage: recruit gap-related reads from each library.

Equivalent of ``main.py -c Collect`` in the reference
(/root/reference/main.py:226-270): per library, classify every
alignment record against the gap focal windows (clip / discordant /
mate-unmapped), run the low-mapq second pass over discordant mate
regions, and union all recruitment records into per-gap read sets;
then merge across libraries (the reference's merge_reads stage).

The device does the hot work (batched classification + interval
joins); the glue (dedup, hash joins against the FASTQ name tables,
segment building) is host-side numpy here — it moves on-device in the
scale-out phase.

Workspace outputs:
  recruits.npz  columns gap, side, lib, row (FASTQ row in that
                library's left/right file), hq (mapq==60 subset flag)
  per-gap FASTQ files under merged/gap_reads/<gap_id>.fastq when
  write_parity_files=True (reference layout, @name_1/_2 renaming)
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..io import bam as bam_io
from ..io import fasta, fastq, native
from ..ops import classify, intervals


# BAMs above this decode via the bounded-memory streaming path. Also a
# PERFORMANCE threshold on sandboxed kernels: the whole-file decoder
# first-touches ~6x the file size in fresh pages, and page faults cost
# ~17us under gVisor-class sandboxes (measured: 40 s whole-file vs
# 15 s streaming for a 627 MB / 27M-record BAM — system time, not CPU)
STREAM_THRESHOLD = 1 << 28


def read_bam_any(path: str) -> bam_io.Alignments:
    """Native (C++) decoder when built, else the pure-Python reader.

    Files above STREAM_THRESHOLD decode through the chunked streaming
    reader: only one BGZF block (plus a record carry) is inflated at a
    time, so peak memory is the columnar output (~52 B/record), not the
    whole decompressed BAM."""
    if os.path.getsize(path) > STREAM_THRESHOLD:
        gen = native.stream_bam_native(path)
        if gen is not None:
            chunks = list(gen)
            if chunks:
                cat = {k: np.concatenate([getattr(c, k) for c in chunks])
                       for k in ("tid", "pos", "flag", "mapq", "mtid",
                                 "mpos", "tlen", "lclip", "rclip",
                                 "nmatch", "read_len", "name_hash")}
                return bam_io.Alignments(refs=chunks[0].refs, names=None,
                                         **cat)
    aln = native.read_bam_native(path)
    return aln if aln is not None else bam_io.read_bam(path)


def read_fastq_any(path: str) -> fastq.ReadSet:
    rs = native.read_fastq_native(path)
    return rs if rs is not None else fastq.read_fastq(path)
from .workspace import Workspace, config_hash
from .preprocess import gap_ids

INT_MAX = np.int32(0x7FFFFFFF)


def _pad_windows(cols: dict[str, np.ndarray], pad_to_multiple: int = 256):
    n = len(cols["tid"])
    m = max(pad_to_multiple, -(-n // pad_to_multiple) * pad_to_multiple)
    out = {}
    for k, v in cols.items():
        pad_val = INT_MAX if k in ("tid", "start") else 0
        a = np.full(m, pad_val, np.int32)
        a[:n] = v
        out[k] = a
    return out


def _tid_map(refs: list[str], names: list[str]) -> np.ndarray:
    """BAM tid -> scaffold index in genome order (-1 if unknown)."""
    lookup = {n: i for i, n in enumerate(names)}
    missing = [r for r in refs if r not in lookup]
    if missing and len(missing) == len(refs):
        import sys
        print(f"[collect] WARNING: none of the BAM's {len(refs)} reference "
              f"names match the draft genome's scaffold names (e.g. BAM "
              f"{missing[0]!r} vs draft {names[0]!r}); no reads can be "
              f"recruited — is this BAM aligned to this draft?",
              file=sys.stderr)
    return np.array([lookup.get(r, -1) for r in refs] + [-1], np.int32)


def _focal_candidate_rows(tid, pos, wtid, wstart, wend):
    """Host pre-filter: ascending indices of records whose (tid, pos)
    lies inside SOME focal window — the only records the device join
    (ops/intervals.interval_join: wstart <= pos <= wend, same tid) can
    ever classify. This is the device-ingest analogue of the
    reference's focal-region position hash
    (collect_reads_for_gaps.py:31-65): the focal regions cover only a
    few percent of the genome, so filtering on host before upload keeps
    the uploaded record rows to those few percent. Exact, not heuristic: windows are merged
    into maximal [start, end] intervals (coverage-preserving), and the
    device re-applies the precise join afterwards anyway."""
    if len(wtid) == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((wstart, wtid))
    SH = np.int64(1) << 34
    ks = wtid[order].astype(np.int64) * SH + wstart[order]
    ke = wtid[order].astype(np.int64) * SH + wend[order]
    run_e = np.maximum.accumulate(ke)
    new = np.ones(len(ks), bool)
    new[1:] = ks[1:] > run_e[:-1]
    ms = ks[new]
    grp = np.cumsum(new) - 1
    me = np.full(int(grp[-1]) + 1, np.iinfo(np.int64).min, np.int64)
    np.maximum.at(me, grp, ke)
    key = np.asarray(tid, np.int64) * SH + np.asarray(pos, np.int64)
    i = np.searchsorted(ms, key, side="right") - 1
    ok = (i >= 0) & (key <= me[np.clip(i, 0, len(me) - 1)])
    return np.flatnonzero(ok)


def make_extract_step(dims, mesh=None, ecap: int = 1 << 15):
    """Jitted recruitment-entry extraction — THE SAME classification
    block the fused slice runs (parallel/slice.py _classify_extract) —
    followed by ON-DEVICE compaction of the valid entries.

    The raw flattened entry arrays are B*fanout*3 rows x 8 columns
    (~12 MB per 32k-record batch) while the live entries are a few
    thousand — compacting before the fetch turns the per-batch
    readback into one ~1 MB transfer ([8, ecap] int32 + counts). Returns (packed, n_valid,
    counts3): packed rows are (gap, side, hash_hi, hash_lo, hq,
    mate_tid, mate_pos) for the first n_valid slots (original entry
    order); n_valid > ecap means truncation — the caller retries with a
    bigger ecap (never silent).
    """
    import functools
    import jax
    import jax.numpy as jnp
    from ..parallel import slice as sl

    def fn(mat, *rep_args):
        # mat: [B, 11] int32 — ONE upload per batch (tid, pos, flag,
        # mapq, mtid, mpos, tlen, lclip, rclip, hash_hi, hash_lo)
        cols = tuple(mat[:, i] for i in range(9))
        hashes = (mat[:, 9].view(jnp.uint32), mat[:, 10].view(jnp.uint32))
        (gap, side, hi, lo, hq, valid), (mt, mp), c3 = \
            sl._classify_extract(*cols, *hashes, *rep_args, dims=dims)
        order = jnp.argsort(~valid, stable=True)[:ecap]
        packed = jnp.stack([
            gap[order].astype(jnp.int32), side[order].astype(jnp.int32),
            hi[order].astype(jnp.uint32).view(jnp.int32),
            lo[order].astype(jnp.uint32).view(jnp.int32),
            hq[order].astype(jnp.int32), mt[order].astype(jnp.int32),
            mp[order].astype(jnp.int32)], axis=1)
        if packed.shape[0] < ecap:      # small batches: keep [ecap, 7]
            packed = jnp.pad(packed, ((0, ecap - packed.shape[0]), (0, 0)))
        # row 0 carries the valid count: ONE readback per batch
        nv_row = jnp.broadcast_to(
            jnp.sum(valid).astype(jnp.int32)[None, None], (1, 7))
        return jnp.concatenate([nv_row, packed], axis=0), c3

    if mesh is None:
        return jax.jit(fn), None
    from jax.sharding import NamedSharding, PartitionSpec as P
    axes = tuple(mesh.axis_names)
    dp, rep = P(axes), P()
    in_specs = (dp,) + (rep,) * 7
    sharded = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs,
        out_specs=(dp, dp), check_vma=False))
    shardings = [NamedSharding(mesh, s) for s in in_specs]
    return sharded, shardings


def collect_library(cfg: Config, lib, gaps: dict[str, np.ndarray],
                    scaffold_names: list[str], aln: bam_io.Alignments,
                    left: fastq.ReadSet, right: fastq.ReadSet,
                    use_device_union: bool = True, mesh=None,
                    initial_ecap: int = 1 << 15):
    """Classify one library; returns recruitment arrays.

    Returns dict with 1-D arrays: gap, side, row, hq (bool) — `row`
    indexes into the side's ReadSet. use_device_union switches the
    final dedup + FASTQ hash-join between the device implementation
    (ops/recruit.py) and the host numpy oracle below.
    """
    dist1 = lib.insert_size - 3 * lib.std
    dist2 = lib.insert_size + 3 * lib.std
    short_insert = lib.insert_size < cfg.long_insert_threshold

    G = len(gaps["start"])
    tmap = _tid_map(aln.refs, scaffold_names)
    tid = tmap[np.clip(aln.tid, -1, len(aln.refs) - 1)]
    mtid = tmap[np.clip(aln.mtid, -1, len(aln.refs) - 1)]

    gap_scaffold = gaps["scaffold"].astype(np.int32)
    gap_start = gaps["local_start"].astype(np.int32)
    gap_end = gaps["local_end"].astype(np.int32)

    win = classify.build_gap_windows(
        jnp.asarray(gap_scaffold), jnp.asarray(gap_start),
        jnp.asarray(gap_end), dist2, cfg.clip_dist)
    wcols = {k: np.asarray(v) for k, v in win.items()}
    fanout = min(2 * G if G else 1,
                 max(4, intervals.max_overlap_np(
                     wcols["tid"], wcols["start"], wcols["end"])))
    res = intervals.sort_windows(jnp.asarray(wcols["tid"]),
                                 jnp.asarray(wcols["start"]),
                                 jnp.asarray(wcols["end"]),
                                 jnp.asarray(wcols["gap"]),
                                 jnp.asarray(wcols["edge"]))
    wp = _pad_windows({"tid": np.asarray(res[0]), "start": np.asarray(res[1]),
                       "end": np.asarray(res[2]), "gap": np.asarray(res[3]),
                       "edge": np.asarray(res[4])})

    # --- pass 1: classify all records in batches through the fused
    # slice's extraction block (parallel/slice.py _classify_extract) ------
    ent_gap, ent_side, ent_hash, ent_hq = [], [], [], []
    mate_tid, mate_pos, mate_gap = [], [], []

    from ..parallel.slice import SliceDims
    dims = SliceDims(
        n_shards=1, n_gaps=max(G, 1), gaps_per_shard=max(G, 1),
        entry_cap=1, reads_per_gap=1,
        fanout=fanout, dist1=dist1, dist2=dist2, clip_dist=cfg.clip_dist,
        anchor_mapq=cfg.anchor_mapq, hq_mapq=cfg.high_quality_mapq,
        short_insert=short_insert, lib=0)
    n_shards = 1
    if mesh is not None:
        n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    ecap = initial_ecap
    extract, shardings = make_extract_step(dims, mesh, ecap)

    B = cfg.device.read_batch
    B = -(-B // n_shards) * n_shards     # shardable batch size
    n = aln.n
    name_hash = np.asarray(aln.name_hash, np.uint64)
    rep_args = (jnp.asarray(wp["tid"]), jnp.asarray(wp["start"]),
                jnp.asarray(wp["end"]), jnp.asarray(wp["gap"]),
                jnp.asarray(wp["edge"]),
                jnp.asarray(gap_start), jnp.asarray(gap_end))
    from ..parallel.mp import to_np

    # focal pre-filter (see _focal_candidate_rows): only records whose
    # position lies in some window can classify — typically a few
    # percent of a whole-genome library, so the device batches (and
    # their uploads) shrink by 10-30x
    cand = _focal_candidate_rows(tid, np.asarray(aln.pos),
                                 wcols["tid"], wcols["start"],
                                 wcols["end"])
    nc = len(cand)
    sub_mat = np.empty((nc, 11), np.int32)
    for i, x in enumerate((tid, aln.pos, aln.flag, aln.mapq, mtid,
                           aln.mpos, aln.tlen, aln.lclip, aln.rclip)):
        sub_mat[:, i] = np.asarray(x, np.int32)[cand]
    hash_sub = name_hash[cand]
    sub_mat[:, 9] = (hash_sub >> np.uint64(32)).astype(
        np.uint32).view(np.int32)
    sub_mat[:, 10] = (hash_sub & np.uint64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)

    def _build_mat(lo, hi):
        pad = B - (hi - lo)
        if not pad:
            return sub_mat[lo:hi]
        mat = np.empty((B, 11), np.int32)
        mat[:hi - lo] = sub_mat[lo:hi]
        mat[hi - lo:] = np.array(
            [-2, -1, 0, 0, -2, -1, 0, 0, 0, 0, 0], np.int32)
        return mat

    def _dispatch(mat):
        args = (jnp.asarray(mat),) + rep_args
        if shardings is not None:
            from ..parallel import mp as pmp
            args = tuple(pmp.put_global(a, s)
                         for a, s in zip(args, shardings))
        return extract(*args)

    # dispatch ahead (async), fetch in order: the device computes
    # batch i+k while batch i's results transfer, instead of
    # serializing upload/compute/fetch per batch. The in-flight
    # window is bounded so a 27M-record library doesn't hold hundreds
    # of staged [B, 11] uploads alive at once.
    MAX_INFLIGHT = 8
    pend = []
    batch_ranges = [(lo, min(lo + B, nc)) for lo in range(0, nc, B)]
    bi = 0

    def _fill_pipeline():
        nonlocal bi
        while bi < len(batch_ranges) and len(pend) < MAX_INFLIGHT:
            lo, hi = batch_ranges[bi]
            mat = _build_mat(lo, hi)
            # record the ecap this batch was dispatched with: after an
            # overflow regrow, in-flight batches still carry the OLD
            # [n_shards*(old_ecap+1), 7] layout and must be parsed with
            # the stride they were produced with, not the current one
            pend.append((mat, ecap, _dispatch(mat)))
            bi += 1

    _fill_pipeline()
    while pend:
        mat, d_ecap, (packed_dev, _c3) = pend.pop(0)
        packed = to_np(packed_dev)
        stride = d_ecap + 1                  # count row + d_ecap entries
        nv = packed[::stride, 0][:n_shards]
        while int(nv.max()) > d_ecap:
            # device compaction overflowed: grow and REDO this batch
            # (shapes are cached per ecap, so this costs one compile)
            ecap = max(ecap, 1 << (int(nv.max()) - 1).bit_length())
            extract, shardings = make_extract_step(dims, mesh, ecap)
            d_ecap = ecap
            packed = to_np(_dispatch(mat)[0])
            stride = d_ecap + 1
            nv = packed[::stride, 0][:n_shards]
        for s in range(n_shards):
            cnt = int(nv[s])
            if cnt == 0:
                continue
            seg = packed[s * stride + 1: s * stride + 1 + cnt]
            eg = seg[:, 0]
            ent_gap.append(eg)
            ent_side.append(seg[:, 1])
            ent_hash.append((seg[:, 2].view(np.uint32).astype(np.uint64)
                             << np.uint64(32)) |
                            seg[:, 3].view(np.uint32).astype(np.uint64))
            ent_hq.append(seg[:, 4].astype(bool))
            # disc third: mate fields are -1-filled outside it; valid
            # disc entries always carry a mapped mate (mtid >= 0)
            emt = seg[:, 5]
            dsel = emt >= 0
            if dsel.any():
                mate_tid.append(emt[dsel])
                mate_pos.append(seg[:, 6][dsel])
                mate_gap.append(eg[dsel])
        _fill_pipeline()

    # --- pass 2: low-mapq reads near discordant mate positions -----------
    if mate_tid and len(np.concatenate(mate_tid)):
        mt = np.concatenate(mate_tid)
        mp = np.concatenate(mate_pos)
        mg = np.concatenate(mate_gap)
        ok = mt >= 0
        mt, mp, mg = mt[ok], mp[ok], mg[ok]
        uniq = np.unique(np.stack([mt, mp, mg]), axis=1)
        mt, mp, mg = uniq
        mw = {"tid": mt, "start": mp - 199, "end": mp + 299,
              "gap": mg, "mp": mp}
        # only the LARGEST covering mate-pos wins (reference dict
        # overwrite), and it is always the last window starting <= pos;
        # fanout need only span one (tid, mp) group of linked gaps.
        _, cnts = np.unique(np.stack([mt, mp]), axis=1, return_counts=True)
        fan2 = min(int(cnts.max()) + 1, max(1, len(mt)))
        res2 = intervals.sort_windows(
            jnp.asarray(mw["tid"]), jnp.asarray(mw["start"]),
            jnp.asarray(mw["end"]), jnp.asarray(mw["gap"]),
            jnp.asarray(mw["mp"]))
        mwp = _pad_windows({"tid": np.asarray(res2[0]),
                            "start": np.asarray(res2[1]),
                            "end": np.asarray(res2[2]),
                            "gap": np.asarray(res2[3]),
                            "mp": np.asarray(res2[4])})
        import functools as _ft
        import jax as _jax

        @_ft.partial(_jax.jit, static_argnames=("fanout", "ecap"))
        def _lowmapq_compact(mat, a, b, c, d, e, *, fanout, ecap):
            gk, sd = classify.classify_lowmapq(
                mat[:, 0], mat[:, 1], mat[:, 2], mat[:, 3], a, b, c, d,
                e, fanout=fanout)
            flat = gk.reshape(-1)
            valid = flat >= 0
            order = jnp.argsort(~valid, stable=True)[:ecap]
            rowi = (order // fanout).astype(jnp.int32)
            packed = jnp.stack([flat[order], sd[rowi], rowi], axis=1)
            if packed.shape[0] < ecap:
                packed = jnp.pad(packed,
                                 ((0, ecap - packed.shape[0]), (0, 0)))
            nv_row = jnp.broadcast_to(
                jnp.sum(valid).astype(jnp.int32)[None, None], (1, 3))
            return jnp.concatenate([nv_row, packed], axis=0)

        ecap2 = 1 << 14
        mw_dev = tuple(jnp.asarray(mwp[k])
                       for k in ("tid", "start", "end", "gap", "mp"))
        # only mapq==0 records are ELIGIBLE in this pass (the
        # reference's `if map_quality>0: continue`,
        # collect_discordant_low_mapq_reads.py:52-53) — pre-filter on
        # the host so the device scans the eligible subset, not all
        # records (a full second sweep of a 27M-record library is
        # hundreds of wasted batches on clean data)
        rows0 = np.flatnonzero(np.asarray(aln.mapq) == 0)
        n0 = len(rows0)
        sub_cols = [np.asarray(x, np.int32)[rows0]
                    for x in (tid, aln.pos, aln.flag, aln.mapq)]
        lo = 0
        while lo < n0:
            hi = min(lo + B, n0)
            take = rows0[lo:hi]
            pad = B - (hi - lo)

            mat2 = np.empty((B, 4), np.int32)
            for i, f in enumerate((-2, -1, 0, 255)):
                mat2[:hi - lo, i] = sub_cols[i][lo:hi]
                if pad:
                    mat2[hi - lo:, i] = f

            packed = np.asarray(_lowmapq_compact(
                jnp.asarray(mat2), *mw_dev, fanout=fan2, ecap=ecap2))
            cnt = int(packed[0, 0])
            if cnt > ecap2:
                ecap2 = 1 << (cnt - 1).bit_length()
                continue                       # redo batch, bigger cap
            seg = packed[1:1 + cnt]
            m = hi - lo
            keep = seg[:, 2] < m               # drop padding rows
            seg = seg[keep]
            if len(seg):
                ent_gap.append(seg[:, 0])
                ent_side.append(seg[:, 1])
                ent_hash.append(aln.name_hash[take][seg[:, 2]])
                ent_hq.append(np.zeros(len(seg), bool))  # mapq==0: not HQ
            lo = hi

    if not ent_gap:
        z = np.zeros(0, np.int32)
        return {"gap": z, "side": z, "row": z, "hq": np.zeros(0, bool)}

    gap_a = np.concatenate(ent_gap).astype(np.int64)
    side_a = np.concatenate(ent_side).astype(np.int64)
    hash_a = np.concatenate(ent_hash)
    hq_a = np.concatenate(ent_hq)

    if use_device_union:
        from ..ops import recruit
        return recruit.recruit_on_device(gap_a, side_a, hash_a, hq_a,
                                         (left, right))

    # --- union/dedup + hash-join against FASTQ name tables ---------------
    out_gap, out_side, out_row, out_hq = [], [], [], []
    for side_val, rs in ((0, left), (1, right)):
        sel = side_a == side_val
        if not sel.any() or rs is None or rs.n == 0:
            continue
        order = np.argsort(rs.name_hash, kind="stable")
        sh = rs.name_hash[order]
        idx = np.searchsorted(sh, hash_a[sel])
        idx = np.clip(idx, 0, len(sh) - 1)
        found = sh[idx] == hash_a[sel]
        rows = order[idx][found]
        gsel = gap_a[sel][found]
        hqsel = hq_a[sel][found]
        # dedup (gap, row); hq flag is OR over duplicates
        key = gsel * (rs.n + 1) + rows
        uk, inv = np.unique(key, return_inverse=True)
        hq_u = np.zeros(len(uk), bool)
        np.logical_or.at(hq_u, inv, hqsel)
        out_gap.append(uk // (rs.n + 1))
        out_row.append(uk % (rs.n + 1))
        out_side.append(np.full(len(uk), side_val, np.int64))
        out_hq.append(hq_u)

    if not out_gap:
        z = np.zeros(0, np.int32)
        return {"gap": z, "side": z, "row": z, "hq": np.zeros(0, bool)}
    return {"gap": np.concatenate(out_gap).astype(np.int32),
            "side": np.concatenate(out_side).astype(np.int32),
            "row": np.concatenate(out_row).astype(np.int32),
            "hq": np.concatenate(out_hq)}


def run_collect(cfg: Config, ws: Workspace,
                genome: fasta.Genome | None = None,
                write_parity_files: bool = False):
    """Run collect for all libraries and merge."""
    # multi-device: shard classification over the configured mesh
    # (reads along dp, tables replicated)
    from ..parallel.mesh import mesh_from_config
    mesh = mesh_from_config(cfg.device.mesh_shape)
    gaps = ws.load_arrays("gaps")
    scaffold_names = ws.load_json("scaffold_names")

    all_cols = {"gap": [], "side": [], "row": [], "hq": [], "lib": []}
    bu_cols = {"lib": [], "side": [], "row": []}
    readsets = []
    map_index = None
    for li, lib in enumerate(cfg.libraries):
        if lib.bam:
            # bounded memory: index the FASTQs (hashes + offsets only);
            # payloads are mmap-gathered for recruited rows at assembly
            left = fastq.scan_fastq(lib.left_fq) if lib.left_fq else None
            right = fastq.scan_fastq(lib.right_fq) if lib.right_fq \
                else None
        else:
            # self-mapping sweeps every payload — load eagerly
            left = read_fastq_any(lib.left_fq) if lib.left_fq else None
            right = read_fastq_any(lib.right_fq) if lib.right_fq else None
        readsets.append((left, right))
        if lib.bam:
            aln = read_bam_any(lib.bam)
        else:
            # self-mapping mode: no external BAM — place the reads on
            # the draft with the built-in minimizer mapper
            from ..ops import minimap
            if left is None or right is None:
                raise ValueError(
                    f"library {li}: self-mapping (bam=None) needs both "
                    "left/right FASTQs")
            if genome is None:
                genome = fasta.read_fasta(cfg.draft_genome)
            if map_index is None:
                map_index = minimap.build_index(genome)
            aln = minimap.map_library(genome, map_index, left, right)
        rec = collect_library(cfg, lib, gaps, scaffold_names, aln,
                              left, right, mesh=mesh)
        for k in ("gap", "side", "row", "hq"):
            all_cols[k].append(rec[k])
        all_cols["lib"].append(np.full(len(rec["gap"]), li, np.int32))

        # both-ends-unmapped pairs for the round-2 rescue
        # (collect_both_unmapped_reads.py:14-34, `samtools view -f 12`)
        bu_hash = np.unique(aln.name_hash[(aln.flag & 12) == 12])
        for side_val, rs in ((0, left), (1, right)):
            if rs is None or rs.n == 0 or not len(bu_hash):
                continue
            order = np.argsort(rs.name_hash, kind="stable")
            sh = rs.name_hash[order]
            idx = np.clip(np.searchsorted(sh, bu_hash), 0, len(sh) - 1)
            found = sh[idx] == bu_hash
            rows = order[idx][found]
            bu_cols["lib"].append(np.full(len(rows), li, np.int32))
            bu_cols["side"].append(np.full(len(rows), side_val, np.int32))
            bu_cols["row"].append(rows.astype(np.int32))

    rec = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
           for k, v in all_cols.items()}
    order = np.lexsort((rec["row"], rec["side"], rec["lib"], rec["gap"]))
    rec = {k: v[order] for k, v in rec.items()}
    ws.save_arrays("recruits", **rec)
    bu = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
          for k, v in bu_cols.items()}
    ws.save_arrays("both_unmapped", **bu)
    ws.mark_done("collect", config_hash(cfg), num_recruits=int(len(rec["gap"])))

    from ..parallel import mp
    if write_parity_files and mp.is_primary():
        _write_gap_fastqs(cfg, ws, gaps, rec, readsets)
        _write_gap_fastqs(cfg, ws, gaps, rec, readsets,
                          subdir="merged/gap_reads_high_quality",
                          hq_only=True)
    return rec, readsets


def _write_gap_fastqs(cfg, ws, gaps, rec, readsets, subdir="merged/gap_reads",
                      hq_only=False):
    """Reference layout: merged/gap_reads/<gap_id>.fastq with _1/_2
    renamed records (run_multi_threads_discordant.py:221,296)."""
    folder = ws.path(subdir)
    os.makedirs(folder, exist_ok=True)
    ids = gap_ids(gaps)
    sel = rec["hq"] if hq_only else np.ones(len(rec["gap"]), bool)
    # records are lexsorted by (gap, lib, side, row): one searchsorted
    # pair per gap instead of a full boolean mask per gap (O(G log N))
    gap_all = rec["gap"]
    use_native = native.available()
    for g in np.unique(gap_all[sel]):
        fpath = os.path.join(folder, f"{ids[g]}.fastq")
        lo = np.searchsorted(gap_all, g, side="left")
        hi = np.searchsorted(gap_all, g, side="right")
        m = slice(lo, hi) if not hq_only else np.flatnonzero(
            sel[lo:hi]) + lo
        libs, sides, rows = rec["lib"][m], rec["side"][m], rec["row"][m]
        if use_native:
            # records are lexsorted by (gap, lib, side, row): one
            # buffered C++ append per (lib, side) run
            open(fpath, "w").close()
            i = 0
            while i < len(rows):
                j = i
                while (j < len(rows) and libs[j] == libs[i]
                       and sides[j] == sides[i]):
                    j += 1
                rs = readsets[libs[i]][sides[i]]
                rows_w = rows[i:j]
                if isinstance(rs, fastq.LazyReadSet):
                    rs = rs.materialize(rows_w)
                    rows_w = np.arange(j - i)
                ok = native.write_fastq_native(
                    fpath, rs, rows_w,
                    suffix="_1" if sides[i] == 0 else "_2", append=True)
                if not ok:
                    raise IOError(f"native FASTQ write failed: {fpath}")
                i = j
            continue
        with open(fpath, "w") as fh:
            for li, side, row in zip(libs, sides, rows):
                rs = readsets[li][side]
                fastq.write_fastq(fh, rs, [row],
                                  suffix="_1" if side == 0 else "_2")
