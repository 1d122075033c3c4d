"""The sharded pipeline dataplane: classify -> gap-home route ->
dedup/join -> group -> multi-k k-mer count -> DBG assembly -> flank
pick scoring, fused in ONE shard_map jit over the device mesh.

This is the production device inner loop of collect+assemble
(SURVEY.md §7 step 6) under its real shardings:

  alignment records, name hashes   sharded along the mesh (dp)
  window/gap tables, FASTQ name
  table, read store, flanks        replicated
  recruitment entries              all-to-all to the gap-home
                                   shard (gap % n_shards) via
                                   parallel/dist.py
  per-gap dedup + join + grouping
  + distinct-k-mer count + unitig
  assembly + flank SW scoring      local to the home shard
  k-mer spectrum histogram,
  class counts                     psum over the mesh

Every gap's read set lands wholly on its home shard, so the per-gap
stages are bit-identical to the single-device program — the property
the mesh-equality tests assert. The reference's counterpart is the
per-gap FASTQ dispatch + per-gap process pool
(/root/reference/run_multi_threads_discordant.py:194-241,
/root/reference/assemble_gaps.py:296-318).

UNIFIED WITH THE SHIPPED PIPELINE (round-3): the blocks below —
`_classify_extract` (collect pass 1), `_route_and_group` (gap-home
union), `_assemble_block` (multi-(k,sub_k) DBG), `_pick_score_block`
(the pick stage's first-pass flank scores, same kernel/params) — are
the SAME functions `pipeline/fused.py` composes for the production
Collect+Assembly run; `_step` fuses them into the one-jit benchmark/
dryrun program. Production semantics are parameterized in SliceDims:
short/long-insert classification, the config's full (k, sub_k) list,
min_kmer_count error filtering, bubble popping. The SW scores come
from ops/sw_xla.py, as in the pick stage. The low-mapq second pass
and the merge/final-pick host stages remain in the host pipeline
(they are host algorithms by design: merge path enumeration +
traceback).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import dna
from ..ops import dbg, kmers, sw_xla
from ..ops.classify import classify_reads
from ..ops.recruit import dedup_and_join
from ..ops.sw_host import BWA_PARAMS
from . import dist

from ..ops.dbg import HIST_BUCKETS


@dataclasses.dataclass(frozen=True)
class SliceDims:
    """Static shape/config bundle for the fused step.

    Production fields mirror Config (pipeline semantics): `kset` is the
    config's (k, sub_k) list, `short_insert`/`dist1`/`dist2` come from
    the library's insert size, `min_kmer_count`/`pop_bubbles` are the
    assembly error filters, `lib` offsets the FASTQ-table side key for
    multi-library runs (side key = 2*lib + side).
    """
    n_shards: int
    n_gaps: int          # global gap count G
    gaps_per_shard: int  # Gl = ceil(G / n_shards)
    entry_cap: int       # per-shard recruit-entry receive capacity E
    reads_per_gap: int   # R
    kset: tuple[tuple[int, int], ...] = ((17, 15),)
    max_distinct: int = 256
    node_cap: int = 0    # 0 = auto: next_pow2(2*max_distinct + 4*k);
    #                      overflow is surfaced in the counts vector
    max_unitigs: int = 4
    max_contig_len: int = 512
    min_contig_len: int = 40
    min_kmer_count: int = 0
    pop_bubbles: int = 0
    # True when Config.max_distinct_kmers is a FIXED positive cap: the
    # k-mer table may then truncate (a semantic the reads-direct fast
    # path cannot replicate), so the counting path must run
    fixed_kmer_cap: bool = False
    fanout: int = 4
    dist1: int = 210
    dist2: int = 390
    clip_dist: int = 250
    anchor_mapq: int = 30
    hq_mapq: int = 60
    short_insert: bool = True
    lib: int = 0

    def effective_node_cap(self, k: int) -> int:
        """The DBG node/edge cap actually used for setting k (auto
        formula when node_cap == 0) — single source of truth for the
        kernel, the dryrun assert and the benches."""
        if self.node_cap:
            return self.node_cap
        return 1 << (2 * self.max_distinct + 4 * k - 1).bit_length()

    @property
    def n_contigs(self) -> int:
        """Contig slots per gap: len(kset) * max_unitigs."""
        return len(self.kset) * self.max_unitigs


# ---------------------------------------------------------------------------
# block 1: classification + recruitment-entry extraction  (collect pass 1)
# ---------------------------------------------------------------------------

def _classify_extract(tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
                      name_hi, name_lo,
                      wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
                      *, dims: SliceDims):
    """Classify records against the gap windows and flatten the hits
    into recruitment entries (gap, side, hi, lo, hq, valid).

    Sides are FASTQ-table keys: 2*dims.lib + (0 left / 1 right).
    Also returns (mate_tid, mate_pos) aligned with the entries — valid
    only in the disc third (clip/unmap thirds are filled with -1); the
    host collect stage inverts these into the low-mapq pass-2 windows
    (/root/reference/run_multi_threads_discordant.py:19-122)."""
    out = classify_reads(
        tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
        wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
        dist1=dims.dist1, dist2=dims.dist2, clip_dist=dims.clip_dist,
        anchor_mapq=dims.anchor_mapq, short_insert=dims.short_insert,
        fanout=dims.fanout)
    counts3 = jnp.stack([jnp.sum(out[k]).astype(jnp.int32)
                         for k in ("clip", "disc", "unmap")])

    parts = []
    neg = jnp.full_like(tid, -1)
    for kind, sidekey in (("clip", "side_self"), ("disc", "side_mate"),
                          ("unmap", "side_mate")):
        mask = out[kind]                       # [B, K]
        gap = out["gap"]
        side = out[sidekey] + 2 * dims.lib
        B, K = mask.shape
        hi = jnp.broadcast_to(name_hi[:, None], (B, K))
        lo = jnp.broadcast_to(name_lo[:, None], (B, K))
        hq = jnp.broadcast_to((mapq == dims.hq_mapq)[:, None], (B, K))
        mt = mtid if kind == "disc" else neg
        mp = mpos if kind == "disc" else neg
        mt = jnp.broadcast_to(mt[:, None], (B, K))
        mp = jnp.broadcast_to(mp[:, None], (B, K))
        parts.append((gap.reshape(-1), side.reshape(-1), hi.reshape(-1),
                      lo.reshape(-1), hq.reshape(-1), mask.reshape(-1),
                      mt.reshape(-1), mp.reshape(-1)))
    cat = tuple(jnp.concatenate([p[i] for p in parts]) for i in range(8))
    gap, side, hi, lo, hq, valid, mt, mp = cat
    return ((gap, side, hi, lo, hq, valid & (gap >= 0)), (mt, mp),
            counts3)


# ---------------------------------------------------------------------------
# block 2: gap-home routing + dedup/join + per-gap grouping
# ---------------------------------------------------------------------------

def _group_rows(gap, row, hq, valid, dims: SliceDims):
    """Scatter joined recruits into a [Gl, R] global-read-row table.

    Rows within a gap are ordered by ascending global row id — the
    (lib, side, row) lexsort order of the host pipeline
    (pipeline/collect.py run_collect), which also makes the table
    mesh-shape-invariant (independent of routing arrival order).

    Returns (rowtab, hqtab, n_reads, n_raw_max): rows beyond R per gap
    are dropped (deterministically, highest row ids first) and
    n_raw_max — the PRE-truncation maximum per-gap count — is
    surfaced so the caller can detect the loss (never silent).
    """
    Gl, R = dims.gaps_per_shard, dims.reads_per_gap
    lg = gap // dims.n_shards
    key = jnp.where(valid, lg, Gl).astype(jnp.int32)
    key_s, grow_s, hq_s = jax.lax.sort(
        (key, row.astype(jnp.int32), hq.astype(jnp.int32)),
        dimension=0, num_keys=2)
    idx = jnp.arange(key.shape[0], dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool),
                             key_s[1:] != key_s[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, idx, 0))
    rank = idx - run_start
    rowtab = jnp.full((Gl, R), -1, jnp.int32).at[
        (key_s, rank)].set(grow_s, mode="drop")
    hqtab = jnp.zeros((Gl, R), bool).at[
        (key_s, rank)].set(hq_s.astype(bool), mode="drop")
    n_reads = jnp.zeros(Gl, jnp.int32).at[key_s].add(
        (key_s < Gl).astype(jnp.int32), mode="drop")
    return (rowtab, hqtab, jnp.minimum(n_reads, R),
            jnp.max(n_reads, initial=0))


def _route_and_group(entries, tbl_hi, tbl_lo, tbl_row, tbl_side,
                     *, dims: SliceDims, axis):
    """Route entries to gap-home shards, dedup + FASTQ-join, group.

    entries: (gap, side, hi, lo, hq, valid) local arrays.
    Returns (rowtab, hqtab, n_reads, over2) where over2 =
    (raw per-gap max, raw router demand) pre-truncation indicators.
    """
    N = dims.n_shards
    gap, side, hi, lo, hq, valid = entries
    (rgap, rside, rhi, rlo, rhq), _src, n_recv = dist.route_shard(
        (gap, side, hi, lo, hq.astype(jnp.int32)),
        dest=gap % N, valid=valid, axis=axis, n_shards=N,
        out_cap=dims.entry_cap)

    g2, s2, row2, hq2, ok2 = dedup_and_join(
        rgap, rside, rhi.astype(jnp.uint32), rlo.astype(jnp.uint32),
        rhq.astype(bool), tbl_hi, tbl_lo, tbl_row, tbl_side)

    rowtab, hqtab, n_reads, n_raw_max = _group_rows(g2, row2, hq2, ok2, dims)
    return rowtab, hqtab, n_reads, (n_raw_max, n_recv[0])


# ---------------------------------------------------------------------------
# block 3: multi-(k, sub_k) distinct-k-mer count + DBG unitig assembly
# ---------------------------------------------------------------------------

def _distinct_kmers(seq, rlen, k: int, dims: SliceDims,
                    read_chunk: int = 512):
    """Distinct canonical k-mers + counts per local gap (pure jit).

    Chunks the read axis exactly like the pipeline's
    assemble.gap_distinct_kmers so saturation behavior matches; applies
    the same min_kmer_count filter (0 = keep all, -1 = adaptive error
    filter, >1 = fixed cutoff). When neither the filter nor bubble
    popping needs multiplicities, the countless merge runs instead
    (same distinct set, one fewer sort operand + no segment sums)."""
    from ..pipeline.assemble import (FULL, _merge_chunk,
                                     _merge_chunk_nocnt, filter_min_count)
    Gl, R, _L = seq.shape
    acc = jnp.full((Gl, dims.max_distinct, kmers.num_limbs(k)),
                   FULL, jnp.uint32)
    if dims.min_kmer_count == 0 and dims.pop_bubbles == 0:
        for lo in range(0, R, read_chunk):
            hi = min(lo + read_chunk, R)
            acc = _merge_chunk_nocnt(seq[:, lo:hi], rlen[:, lo:hi],
                                     acc, k)
        distinct = ~jnp.all(acc == jnp.uint32(FULL), axis=-1)
        cnt = jnp.zeros((Gl, dims.max_distinct), jnp.int32)
    else:
        cnt = jnp.zeros((Gl, dims.max_distinct), jnp.int32)
        for lo in range(0, R, read_chunk):
            hi = min(lo + read_chunk, R)
            acc, cnt = _merge_chunk(seq[:, lo:hi], rlen[:, lo:hi],
                                    acc, cnt, k)
        acc, cnt, distinct = filter_min_count(acc, cnt,
                                              dims.min_kmer_count)
    nk = jnp.sum(distinct, axis=-1).astype(jnp.int32)
    kstr = dbg.unpack_kmers_to_strings(acc, k)
    return acc, kstr, nk, cnt, distinct


def _assemble_block(seq, rlen, dims: SliceDims):
    """All (k, sub_k) settings over the local gap batch.

    Returns (useq [Gl, S*mu, Lc], ulen [Gl, S*mu], ucnt [Gl, S],
    hist [HIST_BUCKETS] from setting 0, over3) where over3 =
    (max raw nodes/edges over settings, max distinct over settings).
    Contig slot s*mu + i holds setting s's unitig i — the name
    "<k>_<sub_k>_<i>" in pipeline terms (host compacts + names).
    """
    Gl = seq.shape[0]
    mu, Lc = dims.max_unitigs, dims.max_contig_len
    useqs, ulens, ucnts = [], [], []
    over_nodes = jnp.zeros((), jnp.int32)
    over_edges = jnp.zeros((), jnp.int32)
    over_nk = jnp.zeros((), jnp.int32)
    hist = jnp.zeros((HIST_BUCKETS,), jnp.int32)
    # the reference pairs each k with SEVERAL sub_k values
    # (configuration.json: {30: (29,27), 40: (39,37), 50: (49,47)});
    # the distinct-k-mer table depends only on k, so compute it once
    # per unique k instead of once per setting (the count stage is the
    # block's biggest sort — do not trust XLA CSE across chunked loops)
    kcache: dict = {}
    for si, (k, sub_k) in enumerate(dims.kset):
        if k not in kcache:
            kcache[k] = _distinct_kmers(seq, rlen, k, dims)
        acc, kstr, nk, kcnt, distinct = kcache[k]
        if si == 0:
            h = (acc[..., 0] >> 16) % HIST_BUCKETS
            hist = jnp.zeros((HIST_BUCKETS,), jnp.int32).at[
                jnp.where(distinct, h, 0).reshape(-1)].add(
                distinct.reshape(-1).astype(jnp.int32), mode="drop")
        over_nk = jnp.maximum(over_nk, jnp.max(nk, initial=0))
    # per-setting DBG dispatch through the shared lane core (the
    # batched-multi path pays occurrence padding + dynamic-sub_k masks;
    # scripts/dbgbench.py compares the two). The gathers/scatters scale
    # with the padded node cap, so SliceDims.node_cap should be set
    # from the scenario's expected distinct count (example_data does;
    # the shipped path derives caps from observed nk).
    res = [dbg.assemble_unitigs(
        kcache[k][1], kcache[k][2], kcache[k][3], k=k, sub_k=sub_k,
        max_unitigs=mu, max_len=Lc, min_len=dims.min_contig_len,
        pop_bubbles=dims.pop_bubbles,
        node_cap=dims.effective_node_cap(k),
        edge_cap=dims.effective_node_cap(k))
        for (k, sub_k) in dims.kset]
    for us, ul, uc, nn_raw, ne_raw in res:
        useqs.append(us)
        ulens.append(ul)
        ucnts.append(uc)
        over_nodes = jnp.maximum(over_nodes, jnp.max(nn_raw))
        over_edges = jnp.maximum(over_edges, jnp.max(ne_raw))
    useq = jnp.concatenate(useqs, axis=1)       # [Gl, S*mu, Lc]
    ulen = jnp.concatenate(ulens, axis=1)
    ucnt = jnp.stack(ucnts, axis=1)             # [Gl, S]
    return useq, ulen, ucnt, hist, (over_nodes, over_edges, over_nk)


# ---------------------------------------------------------------------------
# block 4: flank pick scoring (the pick stage's first SW pass)
# ---------------------------------------------------------------------------

def _pick_score_block(useq, ulen, flank_l, flank_r, flank_ll, flank_rl,
                      dims: SliceDims):
    """Score left/right flanks (fwd + revcomp) against EVERY contig.

    Same kernel family, params (BWA_PARAMS) and mode ("local") as the
    pick stage's first pass (pipeline/pick.py align_flanks_to_contigs).
    Query order qi: 0 = left fwd,
    1 = left rc, 2 = right fwd, 3 = right rc — the pick module's
    convention. Returns (score, qend, tend) int32 [Gl, 4, C].
    """
    Gl, C, Lc = useq.shape
    FL = flank_l.shape[1]
    lf = flank_l
    rf = flank_r
    q4 = jnp.stack([lf, dna.revcomp_jnp(lf, flank_ll),
                    rf, dna.revcomp_jnp(rf, flank_rl)], axis=1)  # [Gl,4,FL]
    ql4 = jnp.stack([flank_ll, flank_ll, flank_rl, flank_rl], axis=1)

    q = jnp.broadcast_to(q4[:, :, None, :], (Gl, 4, C, FL)).reshape(-1, FL)
    ql = jnp.broadcast_to(ql4[:, :, None], (Gl, 4, C)).reshape(-1)
    t = jnp.broadcast_to(useq[:, None], (Gl, 4, C, Lc)).reshape(-1, Lc)
    tl = jnp.broadcast_to(ulen[:, None], (Gl, 4, C)).reshape(-1)

    qc = jnp.maximum(q, 0).astype(jnp.int8)
    tc = jnp.maximum(t, 0).astype(jnp.int8)
    tl1 = jnp.maximum(tl, 1)
    score, qe, te = sw_xla.sw_batch(qc, jnp.maximum(ql, 1), tc, tl1,
                                    BWA_PARAMS, "local")
    live = ((ql > 0) & (tl > 0)).reshape(Gl, 4, C)
    shape = (Gl, 4, C)
    z = jnp.zeros(shape, jnp.int32)
    return (jnp.where(live, score.reshape(shape).astype(jnp.int32), z),
            jnp.where(live, qe.reshape(shape).astype(jnp.int32), z),
            jnp.where(live, te.reshape(shape).astype(jnp.int32), z))


# ---------------------------------------------------------------------------
# the fused one-jit step (benchmark / dryrun / single-chunk production)
# ---------------------------------------------------------------------------

def _step(tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
          name_hi, name_lo,
          wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
          tbl_hi, tbl_lo, tbl_row, tbl_side,
          reads_tbl, reads_len, flank_l, flank_r, flank_ll, flank_rl,
          *, dims: SliceDims, axis):
    N = dims.n_shards
    me = jax.lax.axis_index(axis)

    # ---- block 1: classify my slice of the records ----------------------
    entries, _mates, counts3 = _classify_extract(
        tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
        name_hi, name_lo,
        wtid, wstart, wend, wgap, wedge, gap_start, gap_end, dims=dims)
    counts = jax.lax.psum(counts3, axis)

    # ---- block 2: route to gap-home shards, dedup/join, group ----------
    rowtab, hqtab, n_reads, (n_raw_max, n_recv) = _route_and_group(
        entries, tbl_hi, tbl_lo, tbl_row, tbl_side, dims=dims, axis=axis)

    # ---- gather read payloads (read store replicated) -------------------
    Ntot = reads_tbl.shape[0]
    safe = jnp.clip(rowtab, 0, Ntot - 1)
    live = rowtab >= 0
    seq = jnp.where(live[..., None], reads_tbl[safe], dna.N)
    rlen = jnp.where(live, reads_len[safe], 0)

    # ---- block 3: multi-k distinct k-mers + DBG assembly ----------------
    useq, ulen, ucnt, hist, (o_nodes, o_edges, o_nk) = _assemble_block(
        seq, rlen, dims)
    hist = jax.lax.psum(hist, axis)

    # capacity indicators, pmax'd over the mesh (NEVER silent — see
    # check_overflow): raw node/edge counts (> effective_node_cap =
    # graph truncated), raw per-gap recruit max (> reads_per_gap =
    # read set truncated), distinct-k-mer max (== max_distinct =
    # k-mer table possibly saturated), raw router receive demand
    # (> entry_cap = recruit entries dropped BEFORE grouping — the
    # first truncation point in the chain)
    over = jax.lax.pmax(jnp.stack(
        [o_nodes, o_edges, n_raw_max, o_nk, n_recv]).astype(jnp.int32),
        axis)

    # ---- block 4: flank pick scoring ------------------------------------
    # home = gap % N at local slot gap // N, so slot j holds gap me + j*N
    Gl = dims.gaps_per_shard
    myg = jnp.clip(me + jnp.arange(Gl) * N, 0, dims.n_gaps - 1)
    score, qend, tend = _pick_score_block(
        useq, ulen, flank_l[myg], flank_r[myg], flank_ll[myg],
        flank_rl[myg], dims)

    n_recv_out = jnp.stack([n_recv])
    return (jnp.concatenate([counts, over]), hist, n_recv_out, n_reads,
            rowtab, hqtab, useq, ulen, ucnt, score, qend, tend)


# _step's argument split: the first N_DP_ARGS are sharded along the
# mesh (alignment-record columns + name hashes), the remaining
# N_REP_ARGS are replicated (window/gap tables, FASTQ name table, read
# store, flanks). Single source of truth for make_slice_step,
# place_args and the benches.
N_DP_ARGS = 11
N_REP_ARGS = 17
N_OUT_DP = 10   # all outputs after (counts, hist) are per-shard


def step_specs(mesh):
    """(in_specs, out_specs) for shard_map'ing _step over `mesh`."""
    axes = tuple(mesh.axis_names)
    dp, rep = P(axes), P()
    return ((dp,) * N_DP_ARGS + (rep,) * N_REP_ARGS,
            (rep, rep) + (dp,) * N_OUT_DP)


def check_overflow(dims: SliceDims, counts) -> None:
    """Raise if the step's capacity indicators report truncation.

    Single gate for EVERY static cap in the fused step, including the
    router's entry_cap (the first truncation point): callers need not
    inspect n_recv separately."""
    nodes, edges, raw_reads, nk, raw_recv = (int(x) for x in counts[3:8])
    ncap = min(dims.effective_node_cap(k) for k, _ in dims.kset)
    if raw_recv > dims.entry_cap:
        raise OverflowError(
            f"router receive capacity overflowed ({raw_recv} > "
            f"{dims.entry_cap} entries on some shard): raise "
            "SliceDims.entry_cap")
    if nodes > ncap or edges > ncap:
        raise OverflowError(
            f"DBG node/edge cap {ncap} overflowed ({nodes}/{edges} "
            "distinct): raise SliceDims.node_cap/max_distinct")
    if raw_reads > dims.reads_per_gap:
        raise OverflowError(
            f"per-gap read table overflowed ({raw_reads} > "
            f"{dims.reads_per_gap}): raise SliceDims.reads_per_gap")
    if nk >= dims.max_distinct:
        raise OverflowError(
            f"distinct-k-mer table saturated ({nk} == "
            f"{dims.max_distinct}): raise SliceDims.max_distinct")


@functools.lru_cache(maxsize=64)
def make_slice_step(mesh, dims: SliceDims):
    """Jitted fused step over `mesh` (all axes flattened as dp).

    Cached per (mesh, dims): rebuilding the jit every call would
    re-trace the whole step even when the lowering is cached."""
    axes = tuple(mesh.axis_names)
    axis = axes[0] if len(axes) == 1 else axes
    in_specs, out_specs = step_specs(mesh)
    fn = functools.partial(_step, dims=dims, axis=axis)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False))


# gap-home ownership: gap g lives on shard g % N at local slot g // N
def home_of(gap: np.ndarray, n_shards: int):
    return gap % n_shards, gap // n_shards


def example_data(n_shards: int, gaps_per_shard: int = 2, seed: int = 0,
                 read_len: int = 48, step: int = 4, flank_len: int = 96,
                 gap_len: int | tuple[int, int] = 64,
                 kset=((17, 15),)):
    """Tiny planted scenario: G gaps on one scaffold, clipped reads
    tiling each gap region so the DBG closes it; returns (dims, args)
    ready for make_slice_step.

    gap_len: a fixed length, or an inclusive (lo, hi) range — per-gap
    lengths are then drawn log-uniformly, giving the SKEWED size
    distribution (many short gaps, a long tail) real drafts have; caps
    are sized to the largest gap, so padding waste is part of what a
    skewed measurement honestly charges."""
    from ..ops import intervals
    from ..ops.classify import build_gap_windows

    G = n_shards * gaps_per_shard
    rng = np.random.default_rng(seed)
    if isinstance(gap_len, tuple):
        lo, hi = gap_len
        glens = np.exp(rng.uniform(np.log(lo), np.log(hi), G))
        glens = np.clip(np.round(glens).astype(np.int32), lo, hi)
        gap_len = int(hi)              # caps below size to the largest
    else:
        glens = np.full(G, gap_len, np.int32)
    span, gap_off = 2 * gap_len + 272, gap_len + 136
    L = G * span + 2 * flank_len
    truth = rng.integers(0, 4, L).astype(np.int8)
    gs = np.array([flank_len + g * span + gap_off for g in range(G)],
                  np.int32)
    ge = gs + glens

    # clipped reads tiling [gs - margin, ge + margin)
    recs = {k: [] for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos",
                            "tlen", "lclip", "rclip")}
    names_hi, names_lo, seqs = [], [], []
    margin = read_len - 8
    row = 0
    for g in range(G):
        for a in range(gs[g] - margin, ge[g] + margin - read_len + 1, step):
            b = a + read_len
            seqs.append(truth[a:b])
            # soft-clipped at the nearer gap edge, anchored outside
            if a < gs[g]:
                pos, lc, rc = a, 0, max(b - gs[g], 1)
            else:
                pos, lc, rc = ge[g], max(ge[g] - a, 1), 0
            recs["tid"].append(0)
            recs["pos"].append(pos)
            recs["flag"].append(0x41)     # paired, first in pair
            recs["mapq"].append(60)
            recs["mtid"].append(0)
            recs["mpos"].append(pos)
            recs["tlen"].append(300)
            recs["lclip"].append(lc)
            recs["rclip"].append(rc)
            names_hi.append(0)
            names_lo.append(row)
            row += 1
    n_rec = row
    B = -(-n_rec // n_shards) * n_shards        # pad to shardable
    pad = B - n_rec
    for k in recs:
        fill = -2 if k in ("tid", "mtid") else 0
        recs[k] = np.asarray(recs[k] + [fill] * pad, np.int32)
    name_hi = np.asarray(names_hi + [0xFFFFFFFF] * pad, np.uint32)
    name_lo = np.asarray(names_lo + [0xFFFFFFFF] * pad, np.uint32)

    reads_tbl = np.full((n_rec, read_len), dna.N, np.int8)
    for i, s in enumerate(seqs):
        reads_tbl[i] = s
    reads_len = np.full(n_rec, read_len, np.int32)
    tbl_hi = np.zeros(n_rec, np.uint32)
    tbl_lo = np.arange(n_rec, dtype=np.uint32)
    tbl_row = np.arange(n_rec, dtype=np.int32)   # global read-store rows
    tbl_side = np.zeros(n_rec, np.int32)

    win = build_gap_windows(jnp.zeros(G, jnp.int32), jnp.asarray(gs),
                            jnp.asarray(ge), dist2=390, clip_dist=250)
    res = intervals.sort_windows(win["tid"], win["start"], win["end"],
                                 win["gap"], win["edge"])
    wtid, wstart, wend, wgap, wedge = (np.asarray(r) for r in res)

    flank_l = np.zeros((G, flank_len), np.int8)
    flank_r = np.zeros((G, flank_len), np.int8)
    for g in range(G):
        flank_l[g] = truth[gs[g] - flank_len:gs[g]]
        flank_r[g] = truth[ge[g]:ge[g] + flank_len]
    flank_ll = np.full(G, flank_len, np.int32)
    flank_rl = np.full(G, flank_len, np.int32)

    reads_per_gap_actual = (margin * 2 + gap_len - read_len) // step + 1
    region = 2 * margin + gap_len      # contiguous covered region
    kmax = max(k for k, _ in kset)
    dims = SliceDims(
        n_shards=n_shards, n_gaps=G, gaps_per_shard=gaps_per_shard,
        entry_cap=max(64, 4 * gaps_per_shard * reads_per_gap_actual),
        reads_per_gap=1 << (reads_per_gap_actual - 1).bit_length(),
        kset=tuple(kset),
        # distinct k-mers per gap <= tiled region length (contiguous)
        max_distinct=1 << region.bit_length(),
        max_contig_len=1 << (gap_len + 2 * margin).bit_length(),
        # DBG caps from the EXPECTED distinct count (2 strands of a
        # contiguous region), not from the padded table size: the
        # gathers/scatters scale with the padded cap;
        # check_overflow still guards against undersizing
        node_cap=1 << (2 * region + 4 * kmax).bit_length())

    args = (recs["tid"], recs["pos"], recs["flag"], recs["mapq"],
            recs["mtid"], recs["mpos"], recs["tlen"], recs["lclip"],
            recs["rclip"], name_hi, name_lo,
            wtid, wstart, wend, wgap, wedge, gs, ge,
            tbl_hi, tbl_lo, tbl_row, tbl_side,
            reads_tbl, reads_len, flank_l, flank_r, flank_ll, flank_rl)
    return dims, args


def arg_shardings(mesh):
    """The step's input shardings (N_DP_ARGS dp + N_REP_ARGS repl.)."""
    axes = tuple(mesh.axis_names)
    dp = NamedSharding(mesh, P(axes))
    rep = NamedSharding(mesh, P())
    return [dp] * N_DP_ARGS + [rep] * N_REP_ARGS


def place_args(mesh, args):
    """device_put each arg with the step's sharding (single process)."""
    return tuple(jax.device_put(a, s)
                 for a, s in zip(args, arg_shardings(mesh)))


def place_args_global(mesh, args):
    """Multi-process placement: every process passes the same GLOBAL
    numpy args; each materialises only its addressable shards."""
    out = []
    for a, s in zip(args, arg_shardings(mesh)):
        a = np.asarray(a)
        out.append(jax.make_array_from_callback(
            a.shape, s, lambda idx, _a=a: _a[idx]))
    return tuple(out)
