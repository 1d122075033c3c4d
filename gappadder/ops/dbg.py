"""Batched de-Bruijn unitig assembly — the Velvet replacement (L2).

The reference assembles each gap's DISTINCT canonical k-mers (KMC
output) with Velvet at a smaller sub_k
(velveth/velvetg, /root/reference/assemble_gaps.py:104-122). Here the
same computation is expressed as fixed-shape array ops so thousands of
gaps assemble in parallel on device:

  nodes  = distinct sub_k-mers of the k-strings (+ their revcomps:
           double-stranded graph, like Velvet's)
  edges  = distinct (sub_k+1)-mers; edge u->v where u/v are the
           prefix/suffix sub_k-mers (every such u, v is a node by
           construction)
  unitig = maximal chain through nodes with outdeg(u)==1 == indeg(v)
           along kept edges; compacted by pointer doubling (parallel
           list ranking), cycles broken at their minimum node id
  emit   = top `max_unitigs` chains by length >= min_len, materialized
           as code arrays; reverse-complement twins deduplicated by
           keeping the lexicographically smaller strand.

Optional coverage-guided bubble popping (`pop_bubbles` rounds) is the
array-ops equivalent of Velvet's tour-bus: when two short parallel
chains leave the same fork and rejoin at the same node, the branch
with the lower minimum k-mer coverage (a sequencing-error path) is
deleted, letting the fork/winner/join chains fuse into one unitig on
the next round. Coverage comes from the per-k-mer multiplicities the
counting stage already produces (`kcounts`).

Everything is O(E log E) sorts + gathers/scatters + O(log N) doubling
steps; one gap is one vmap lane, so a [G, ...] batch runs as one XLA
program (SURVEY.md §7 "hard parts" #1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import dna
from . import kmers

FULL = jnp.uint32(0xFFFFFFFF)
HIST_BUCKETS = 512      # spectrum buckets (shared with parallel/slice.py)


def _lex_less(a, b):
    """Lexicographic a < b over trailing limb axis (uint32)."""
    nl = a.shape[-1]
    lt = jnp.zeros(a.shape[:-1], bool)
    gt = jnp.zeros(a.shape[:-1], bool)
    for l in range(nl):
        x, y = a[..., l], b[..., l]
        lt = lt | (~gt & ~lt & (x < y))
        gt = gt | (~lt & ~gt & (x > y))
    return lt


def _unique_compact(limbs):
    """Sort [..., P, nl] k-mers, drop duplicates, compact to front.

    Compaction is a cumsum-rank scatter (no second sort).

    Returns (keys [..., P, nl] sorted-unique then FULL padding,
             n [...] distinct count excluding FULL)."""
    s, _ = kmers.sort_kmers(limbs)
    first = kmers.unique_mask(s)
    validk = ~jnp.all(s == FULL, axis=-1)
    keep = first & validk
    n = jnp.sum(keep, axis=-1).astype(jnp.int32)
    P, nl = limbs.shape[-2], limbs.shape[-1]
    rank = jnp.cumsum(keep, axis=-1) - 1
    tgt = jnp.where(keep, rank, P)
    lead = s.shape[:-2]
    s2 = s.reshape((-1, P, nl))
    t2 = tgt.reshape((-1, P))
    b = jnp.arange(s2.shape[0], dtype=jnp.int32)[:, None]
    keys = jnp.full((s2.shape[0], P + 1, nl), FULL, jnp.uint32).at[
        b, t2].set(s2, mode="drop")[:, :P]
    return keys.reshape(lead + (P, nl)), n


def _prefix_kmer(edge_limbs, sub_k: int):
    """First sub_k bases of a (sub_k+1)-mer (same limb layout)."""
    nl_out = kmers.num_limbs(sub_k)
    out = []
    for l in range(nl_out):
        v = edge_limbs[..., l]
        used = min(16, sub_k - 16 * l)  # bases of this limb in prefix
        mask = jnp.uint32(((1 << (2 * used)) - 1) << (32 - 2 * used))
        out.append(v & mask)
    res = jnp.stack(out, axis=-1)
    invalid = jnp.all(edge_limbs == FULL, axis=-1, keepdims=True)
    return jnp.where(invalid, FULL, res)


def _suffix_kmer(edge_limbs, sub_k: int):
    """Last sub_k bases of a (sub_k+1)-mer: shift left by one base."""
    nl_in = edge_limbs.shape[-1]
    nl_out = kmers.num_limbs(sub_k)
    out = []
    for l in range(nl_out):
        v = edge_limbs[..., l] << 2
        if l + 1 < nl_in:
            v = v | (edge_limbs[..., l + 1] >> 30)
        used = min(16, sub_k - 16 * l)
        mask = jnp.uint32(((1 << (2 * used)) - 1) << (32 - 2 * used))
        out.append(v & mask)
    res = jnp.stack(out, axis=-1)
    invalid = jnp.all(edge_limbs == FULL, axis=-1, keepdims=True)
    return jnp.where(invalid, FULL, res)


def _kmer_base(limbs, i: int):
    """Base code at position i of a packed k-mer."""
    l, j = divmod(i, 16)
    return ((limbs[..., l] >> (30 - 2 * j)) & 0x3).astype(jnp.int8)


def _prefix_kmer_dyn(edge_limbs, sub_k):
    """First sub_k bases of a packed (sub_k+1)-mer, sub_k TRACED (a
    per-vmap-lane scalar in the multi-setting batched core)."""
    nl = edge_limbs.shape[-1]
    out = []
    for l in range(nl):
        used = jnp.clip(sub_k - 16 * l, 0, 16).astype(jnp.uint32)
        mask = jnp.where(used > 0,
                         FULL << (jnp.uint32(32) - 2 * used),
                         jnp.uint32(0))
        out.append(edge_limbs[..., l] & mask)
    res = jnp.stack(out, axis=-1)
    invalid = jnp.all(edge_limbs == FULL, axis=-1, keepdims=True)
    return jnp.where(invalid, FULL, res)


def _suffix_kmer_dyn(edge_limbs, sub_k):
    """Last sub_k bases of a packed (sub_k+1)-mer, sub_k traced."""
    nl = edge_limbs.shape[-1]
    out = []
    for l in range(nl):
        v = edge_limbs[..., l] << 2
        if l + 1 < nl:
            v = v | (edge_limbs[..., l + 1] >> 30)
        used = jnp.clip(sub_k - 16 * l, 0, 16).astype(jnp.uint32)
        mask = jnp.where(used > 0,
                         FULL << (jnp.uint32(32) - 2 * used),
                         jnp.uint32(0))
        out.append(v & mask)
    res = jnp.stack(out, axis=-1)
    invalid = jnp.all(edge_limbs == FULL, axis=-1, keepdims=True)
    return jnp.where(invalid, FULL, res)


def _kmer_base_dyn(limbs, i):
    """Base code at TRACED position i of a packed k-mer (select over
    the static limb axis — nl <= 4, so this is a couple of wheres)."""
    l = i // 16
    j = (i % 16).astype(jnp.uint32)
    sh = jnp.uint32(30) - 2 * j
    sel = jnp.zeros(limbs.shape[:-1], jnp.uint32)
    for ll in range(limbs.shape[-1]):
        cand = (limbs[..., ll] >> sh) & 0x3
        sel = jnp.where(l == ll, cand, sel)
    return sel.astype(jnp.int8)


def _join_ids_safe(node_keys, query_keys):
    """For each query k-mer, the index of its key in node_keys.

    node_keys: [N, nl] sorted-unique (FULL padded); query_keys: [Q, nl].
    Sort-merge join: tag nodes 0 / queries 1, sort by (key, tag), then
    forward-propagate the last node id (cummax works because node ids
    increase with key order). All non-FULL queries are guaranteed hits
    here (every edge prefix/suffix is a node); FULL queries are masked
    by callers.
    """
    N, nl = node_keys.shape
    Q = query_keys.shape[0]
    keys = jnp.concatenate([node_keys, query_keys], axis=0)
    tag = jnp.concatenate([jnp.zeros(N, jnp.int32), jnp.ones(Q, jnp.int32)])
    payload = jnp.concatenate([jnp.arange(N, dtype=jnp.int32),
                               jnp.arange(Q, dtype=jnp.int32)])
    ops = [keys[:, l] for l in range(nl)] + [tag, payload]
    res = jax.lax.sort(tuple(ops), dimension=0, num_keys=nl + 1)
    stag, spay = res[nl], res[nl + 1]
    nid = jnp.where(stag == 0, spay, -1)
    prop = jax.lax.cummax(nid)
    is_q = stag == 1
    # scatter: only query rows write (non-query rows target dumping slot Q)
    tgt = jnp.where(is_q, spay, Q)
    out = jnp.zeros(Q + 1, jnp.int32).at[tgt].set(prop, mode="drop")
    return out[:Q]


def _graph_chains(u_id_raw, v_id_raw, edge_valid, node_valid, N: int,
                  sub_k: int):
    """Degrees + chain-edge compaction by pointer doubling.

    Factored so bubble-pop rounds can recompute the chain structure
    after deleting branches. Returns a dict of the per-graph arrays the
    popping and emission passes need.
    """
    u_id = jnp.where(edge_valid, u_id_raw, N)
    v_id = jnp.where(edge_valid, v_id_raw, N)
    outdeg = jnp.zeros(N + 1, jnp.int32).at[u_id].add(1, mode="drop")
    indeg = jnp.zeros(N + 1, jnp.int32).at[v_id].add(1, mode="drop")
    chain = edge_valid & (outdeg[u_id] == 1) & (indeg[v_id] == 1)
    # prev[v] = u along chain edges; prev[x] = x elsewhere
    prev = jnp.arange(N + 1, dtype=jnp.int32)
    prev = prev.at[jnp.where(chain, v_id, N)].set(
        jnp.where(chain, u_id, N), mode="drop")
    is_head = prev[:N] == jnp.arange(N)     # no incoming chain edge
    is_head = is_head & node_valid

    # ---- pointer doubling: find head + cycle break + list ranking -------
    # The structure minimizes GATHER COUNT, not flops:
    #   * ONE fused chain carries (mn, p) packed in an int32 word plus
    #     the hop rank `off` unpacked; each step gathers the pair
    #     [w, off] as one [N, 2] row gather. prev restricted to chain
    #     edges is a partial permutation, so components are simple
    #     paths or simple cycles — path nodes converge to their head
    #     (a prev fixed point) with `off` = exact hops-to-head, cycle
    #     nodes never converge and their (p, off) are fixed up below.
    #     T = bit_length(2N - 1) steps cover any path or cycle, so `mn`
    #     sees the whole cycle for the min-id break.
    #   * the cycle FIXUP chain re-ranks with the broken-cycle heads as
    #     fixed points. Path-node results always come from the fused
    #     chain; cycle-node results from the fixup.
    # Packing needs N < 2^15 so (mn << shift | p) stays below 2^31;
    # falls back to two-gather loops otherwise.
    T = max(1, (2 * N - 1).bit_length())
    shift = N.bit_length()
    packed_ok = 2 * shift <= 30
    idx32 = jnp.arange(N, dtype=jnp.int32)

    p = prev[:N]
    mn = idx32                              # min id seen on prefix path
    off = jnp.where(is_head, 0, 1).astype(jnp.int32)
    if packed_ok:
        # one fused chain carrying (mn << shift | p) packed + off, with
        # one [N, 2] row gather per step
        lo = (1 << shift) - 1

        # unrolled T-step chain (an early-exit while_loop is the
        # alternative; which lowers better on the GPU is unmeasured)
        w = (mn << shift) | p
        for _ in range(T):
            g = jnp.stack([w, off], axis=-1)[w & lo]    # one [N,2] gather
            gw = g[..., 0]
            w = jnp.minimum(w & ~lo, gw & ~lo) | (gw & lo)
            off = off + g[..., 1]
        mn = w >> shift
        p = w & lo
    else:
        for _ in range(T):
            mn = jnp.minimum(mn, mn[p])
            off = off + off[p]
            p = p[p]
    reached_head = is_head[p]
    new_head = is_head | (node_valid & ~reached_head & (mn == idx32))

    # cycle fixup: re-rank with the min-id break nodes as heads (its
    # results are used for cycle nodes only)
    p2 = jnp.where(new_head, idx32, prev[:N])
    off2 = jnp.where(new_head, 0, 1).astype(jnp.int32)
    for _ in range(T):
        g = jnp.stack([p2, off2], axis=-1)[p2]
        p2 = g[..., 0]
        off2 = off2 + g[..., 1]
    off = jnp.where(reached_head, off, off2)
    rep = jnp.where(reached_head, p, p2)     # head node of each chain

    chain_nodes = jnp.zeros(N + 1, jnp.int32).at[
        jnp.where(node_valid, rep, N)].max(off + 1, mode="drop")
    ulen_all = jnp.where(new_head, sub_k + chain_nodes[:N] - 1, -1)
    tail_of = jnp.full(N + 1, -1, jnp.int32).at[
        jnp.where(node_valid & (off == chain_nodes[rep] - 1), rep, N)
    ].set(jnp.arange(N, dtype=jnp.int32), mode="drop")[:N]
    return dict(u_id=u_id, v_id=v_id, outdeg=outdeg, indeg=indeg,
                chain=chain, is_head=is_head, new_head=new_head, rep=rep,
                off=off, chain_nodes=chain_nodes, ulen_all=ulen_all,
                tail_of=tail_of)


def _node_coverage(node_keys, occ_keys, occ_valid, occ_w):
    """Coverage of each DBG node: sum of source-string multiplicities
    over every occurrence of the node's sub_k-mer.

    occ_keys: [Q, nl] flattened sub_k-mer occurrences; occ_valid: [Q];
    occ_w: int32 [Q] weight of each occurrence (its source string's
    multiplicity)."""
    ids = _join_ids_safe(node_keys, occ_keys)
    N = node_keys.shape[0]
    cov = jnp.zeros(N + 1, jnp.int32).at[
        jnp.where(occ_valid, ids, N)].add(
        jnp.where(occ_valid, occ_w, 0), mode="drop")
    return cov[:N]


def _pop_bubbles_round(g, cov, edge_valid, node_valid, N: int,
                       max_bubble_len: int):
    """One tour-bus round: delete the lowest-min-coverage branch of
    every simple bubble (two clean chains sharing fork and join).

    A branch is a proper chain head h with a unique in-edge from a fork
    f (outdeg>=2) whose tail t has a unique out-edge into a join j
    (indeg>=2), of limited length. Branches grouped by (f, j); the one
    with the highest minimum node coverage survives (ties: smaller head
    id). Returns updated (node_valid, edge_valid).
    """
    idxN = jnp.arange(N, dtype=jnp.int32)
    big = jnp.int32(1 << 30)
    # min node coverage per chain, keyed by head
    chaincov = jnp.full(N + 1, big, jnp.int32).at[
        jnp.where(node_valid, g["rep"], N)].min(
        jnp.where(node_valid, cov, big), mode="drop")[:N]
    # unique in-edge source / unique out-edge target (valid only where
    # the corresponding degree is exactly 1 — callers check degrees)
    in1 = jnp.full(N + 1, -1, jnp.int32).at[g["v_id"]].max(
        jnp.where(edge_valid, g["u_id"], -1), mode="drop")[:N]
    next1 = jnp.full(N + 1, -1, jnp.int32).at[g["u_id"]].max(
        jnp.where(edge_valid, g["v_id"], -1), mode="drop")[:N]

    indeg, outdeg = g["indeg"], g["outdeg"]
    f = in1
    fc = jnp.clip(f, 0, N - 1)
    t = g["tail_of"]
    tc = jnp.clip(t, 0, N - 1)
    j = next1[tc]
    cand = (g["is_head"] & node_valid
            & (indeg[:N] == 1) & (f >= 0) & (f != idxN)
            & (outdeg[fc] >= 2)
            & (t >= 0) & (outdeg[tc] == 1) & (j >= 0)
            & (indeg[jnp.clip(j, 0, N - 1)] >= 2)
            & (g["ulen_all"] <= max_bubble_len))

    # group branches by (fork, join); winner = first after sorting by
    # (f, j, -min_cov, head id)
    fkey = jnp.where(cand, f, N + 1)
    jkey = jnp.where(cand, j, N + 1)
    negcov = jnp.where(cand, -chaincov, 0)
    sf, sj, _, sh = jax.lax.sort((fkey, jkey, negcov, idxN),
                                 dimension=0, num_keys=4)
    same = (sf == jnp.roll(sf, 1)) & (sj == jnp.roll(sj, 1))
    same = same.at[0].set(False)
    loser_sorted = same & (sf <= N)
    loser_head = jnp.zeros(N + 1, bool).at[
        jnp.where(loser_sorted, sh, N)].set(True, mode="drop")[:N]

    removed = node_valid & loser_head[g["rep"]]
    node_valid = node_valid & ~removed
    removed_p = jnp.concatenate([removed, jnp.zeros(1, bool)])
    edge_valid = edge_valid & ~removed_p[g["u_id"]] & ~removed_p[g["v_id"]]
    return node_valid, edge_valid


def _core_lane(occ_keys, sub_k, covdata, *, sub_k_max: int,
               max_unitigs: int, max_len: int, min_len: int,
               pop_bubbles: int = 0, max_bubble_len: int | None = None,
               node_cap: int, edge_cap: int):
    """DBG build + unitig emission for ONE (gap, setting) lane.

    occ_keys: [Q, nl] flattened (sub_k+1)-mer occurrence keys of the
    lane's k-strings + revcomps (FULL-padded); the graph depends only
    on their DISTINCT set. sub_k is a TRACED scalar — the multi-setting
    entry batches lanes with different sub_k through one program, with
    sub_k_max the static bound for emission loops. covdata: None, or
    (keys [Qn, nl], valid [Qn], w [Qn]) sub_k-mer occurrences for
    bubble-pop coverage.
    """
    # ---- edges, then nodes FROM the edges --------------------------------
    # Every sub_k-mer of a k-string (k > sub_k) is the prefix or suffix
    # of one of its (sub_k+1)-mers, so the node set is exactly the set
    # of distinct edge endpoints: one sort of the [2E] endpoint list
    # yields node enumeration (rank of first occurrence), u_id/v_id
    # (rank scattered back through the sort payload) AND the compacted
    # sorted-unique node_keys.
    edge_keys, n_edges = _unique_compact(occ_keys[None])
    edge_keys, n_edges = edge_keys[0], n_edges[0]
    n_edges_raw = n_edges
    if edge_cap < edge_keys.shape[0]:
        edge_keys = edge_keys[:edge_cap]
        n_edges = jnp.minimum(n_edges, edge_cap)
    E = edge_keys.shape[0]
    edge_valid = jnp.arange(E) < n_edges

    u_keys = _prefix_kmer_dyn(edge_keys, sub_k)
    v_keys = _suffix_kmer_dyn(edge_keys, sub_k)
    nl = u_keys.shape[-1]
    q = jnp.concatenate([u_keys, v_keys], axis=0)             # [2E, nl]
    pay = jnp.arange(2 * E, dtype=jnp.int32)
    ops = tuple(q[:, l] for l in range(nl)) + (pay,)
    res = jax.lax.sort(ops, dimension=0, num_keys=nl)
    sq = jnp.stack(res[:nl], axis=-1)                         # [2E, nl]
    spay = res[nl]
    vrow = ~jnp.all(sq == FULL, axis=-1)
    firsts = kmers.unique_mask(sq) & vrow
    rank = jnp.cumsum(firsts.astype(jnp.int32)) - 1           # id per row
    n_nodes_raw = jnp.sum(firsts).astype(jnp.int32)

    N = node_cap
    n_nodes = jnp.minimum(n_nodes_raw, N)
    node_valid = jnp.arange(N) < n_nodes
    rank_c = jnp.clip(rank, 0, N - 1)
    # compacted sorted-unique node keys (scatter first occurrences)
    node_keys = jnp.full((N + 1, nl), FULL, jnp.uint32).at[
        jnp.where(firsts & (rank < N), rank_c, N)].set(
        sq, mode="drop")[:N]
    # endpoint ids back to edge order (garbage-but-bounded on overflow,
    # flagged via n_nodes_raw — caller retries bigger, like before)
    ids = jnp.zeros(2 * E, jnp.int32).at[spay].set(rank_c)
    u_id_raw, v_id_raw = ids[:E], ids[E:]

    # ---- bubble popping (tour-bus equivalent) ----------------------------
    if pop_bubbles > 0:
        cov = _node_coverage(node_keys, *covdata)
        mbl = (2 * (sub_k + 1) if max_bubble_len is None
               else max_bubble_len)
        for _ in range(pop_bubbles):
            g = _graph_chains(u_id_raw, v_id_raw, edge_valid, node_valid,
                              N, sub_k)
            node_valid, edge_valid = _pop_bubbles_round(
                g, cov, edge_valid, node_valid, N, mbl)

    g = _graph_chains(u_id_raw, v_id_raw, edge_valid, node_valid, N, sub_k)
    u_id, v_id = g["u_id"], g["v_id"]
    outdeg, indeg = g["outdeg"], g["indeg"]
    new_head, rep, off = g["new_head"], g["rep"], g["off"]
    chain_nodes, ulen_all, tail_of = (g["chain_nodes"], g["ulen_all"],
                                      g["tail_of"])

    # Velvet-style tip clipping: a SHORT chain (< 2*(sub_k+1), Velvet's
    # default max tip length 2k) that dangles dead at one end AND whose
    # attached junction has an ALTERNATIVE continuation is a
    # sequencing-error spur. A dead end with no competing branch is a
    # legitimate sequence end and is kept.
    head_dead = indeg[:N] == 0
    tailc = jnp.clip(tail_of, 0, N - 1)
    tail_dead = jnp.where(tail_of >= 0, outdeg[tailc] == 0, True)
    # per-node: does any predecessor have outdeg>=2 / any successor
    # have indeg>=2 (an alternative branch at the junction)?
    pred_branch = jnp.zeros(N + 1, jnp.int32).at[v_id].max(
        outdeg[u_id], mode="drop")[:N] >= 2
    succ_branch = jnp.zeros(N + 1, jnp.int32).at[u_id].max(
        indeg[v_id], mode="drop")[:N] >= 2
    tip_a = head_dead & ~tail_dead & succ_branch[tailc] & (tail_of >= 0)
    tip_b = ~head_dead & tail_dead & pred_branch
    is_tip = new_head & (tip_a | tip_b) & (ulen_all < 2 * (sub_k + 1))

    eligible = new_head & (ulen_all >= min_len) & ~is_tip
    sort_key = jnp.where(eligible, -ulen_all, 1)
    order = jnp.argsort(sort_key, stable=True)          # longest first
    top = order[:max_unitigs]
    top_ok = eligible[top]
    uidx_of = jnp.full(N + 1, -1, jnp.int32).at[
        jnp.where(top_ok, top, N)].set(
        jnp.where(top_ok, jnp.arange(max_unitigs, dtype=jnp.int32), -1),
        mode="drop")

    # ---- materialize sequences ------------------------------------------
    U = max_unitigs
    lens = jnp.zeros(U, jnp.int32)
    # head prefixes: gather the top-k heads' packed k-mers ([U] rows)
    # and lay their sub_k bases into columns — no scatter needed
    head_keys = node_keys[jnp.clip(top, 0, N - 1)]          # [U, nl]
    cols = min(sub_k_max, max_len)
    prefix = jnp.stack([_kmer_base(head_keys, b)
                        for b in range(cols)], axis=1)      # [U, cols]
    colmask = (jnp.arange(cols)[None, :]
               < jnp.minimum(sub_k, max_len)) & top_ok[:, None]
    # tail bases: node v at offset o>=1 contributes its last base.
    # SORT-then-GATHER, not a 2-D scatter: sort nodes by (unitig,
    # offset) so each unitig's chain is a contiguous ascending run,
    # then fill out[u, p] with one [U, max_len] gather instead of a
    # coordinate scatter into [U, max_len]
    vuid = uidx_of[jnp.where(node_valid, rep, N)]
    lastb = _kmer_base_dyn(node_keys, sub_k - 1)
    w = (vuid >= 0) & (off >= 1) & node_valid
    SHIFT = jnp.int32(1) << 16                    # off < N <= 2^15
    skey = jnp.where(w, vuid, U) * SHIFT + jnp.where(w, off, 0)
    skey_s, lastb_s = jax.lax.sort(
        (skey, lastb.astype(jnp.int32)), dimension=skey.ndim - 1, num_keys=1)
    # seg_start[u] = first sorted slot of unitig u (off >= 1 entries)
    seg_start = jnp.searchsorted(skey_s, jnp.arange(U) * SHIFT)
    pcol = jnp.arange(max_len, dtype=jnp.int32)[None, :]    # [1, L]
    gidx = seg_start[:, None] + pcol - sub_k
    tail_ok = (pcol >= jnp.minimum(sub_k, max_len)) & \
        (pcol < jnp.minimum(ulen_all[top], max_len)[:, None]) & \
        top_ok[:, None]
    tails = lastb_s[jnp.clip(gidx, 0, skey_s.shape[0] - 1)]
    out = jnp.where(tail_ok, tails.astype(jnp.int8), dna.N)
    if cols:
        out = out.at[:, :cols].set(
            jnp.where(colmask, prefix,
                      jnp.where(tail_ok[:, :cols],
                                tails[:, :cols].astype(jnp.int8),
                                dna.N)))
    lens = jnp.zeros(U + 1, jnp.int32).at[jnp.where(top_ok, jnp.arange(U), U)].set(
        jnp.where(top_ok, jnp.minimum(ulen_all[top], max_len), 0),
        mode="drop")[:U]

    # ---- revcomp twin dedup ---------------------------------------------
    rcseq = dna.revcomp_jnp(out, lens)
    # lexicographic compare out vs rcseq over max_len (N-padded equal tails)
    diff = out != rcseq
    any_diff = jnp.any(diff, axis=1)
    fd = jnp.argmax(diff, axis=1)
    a = jnp.take_along_axis(out, fd[:, None], axis=1)[:, 0]
    b = jnp.take_along_axis(rcseq, fd[:, None], axis=1)[:, 0]
    # PATH unitigs: the twin path's linearization is the exact revcomp,
    # so keeping only the lex-canonical strand dedups the pair. CYCLE
    # unitigs (head created by the min-id cycle break, i.e. NOT a
    # prev fixed point): the twin cycle breaks at ITS min-id node, a
    # generally different rotation — rc(S_A) != S_B — so strand-dropping
    # can kill BOTH twins. Emit every cycle linearization on its
    # canonical strand instead (both rotations survive, matching the
    # brute-force oracle's min(s, rc(s)) per broken cycle).
    cyc_head = top_ok & ~g["is_head"][jnp.clip(top, 0, N - 1)]
    keep = ~any_diff | (a <= b) | cyc_head
    out = jnp.where((cyc_head & any_diff & (b < a))[:, None], rcseq, out)
    keep = keep & (lens > 0)
    order2 = jnp.argsort(~keep, stable=True)
    out = out[order2]
    lens = jnp.where(keep[order2], lens[order2], 0)
    count = jnp.sum(keep).astype(jnp.int32)
    out = jnp.where((jnp.arange(U) < count)[:, None], out, dna.N)
    return out, lens, count, n_nodes_raw, n_edges_raw


def _occurrence_prep(kstrings, n_kstrings, kcounts, *, k: int, sub_k: int,
                     nl_pad: int, occ_cap: int, occn_cap: int,
                     pop_bubbles: int):
    """Per-setting host of the batched core: flattened padded
    (sub_k+1)-mer occurrence keys [G, occ_cap, nl_pad] of the distinct
    k-mer strings + revcomps, and (when bubble-popping) the sub_k-mer
    occurrence (keys, valid, weights) for coverage. Limb padding keeps
    lexicographic order (zero tail limbs, FULL on invalid rows)."""
    G, M, kk = kstrings.shape
    assert kk == k and sub_k < k
    row_valid = jnp.arange(M)[None, :] < n_kstrings[:, None]
    fwd = jnp.where(row_valid[..., None], kstrings, dna.N)
    rc = dna.revcomp_jnp(fwd)
    both = jnp.concatenate([fwd, rc], axis=1)                # [G, 2M, k]
    blen = jnp.where(jnp.concatenate([row_valid, row_valid], axis=1),
                     k, 0)

    def _flat_pad(limbs, cap):
        nl = limbs.shape[-1]
        flat = limbs.reshape(G, -1, nl)
        if nl < nl_pad:
            inval = jnp.all(flat == FULL, axis=-1, keepdims=True)
            tail = jnp.where(inval, FULL, jnp.uint32(0))
            flat = jnp.concatenate(
                [flat] + [tail] * (nl_pad - nl), axis=-1)
        if flat.shape[1] < cap:
            flat = jnp.pad(flat, ((0, 0), (0, cap - flat.shape[1]),
                                  (0, 0)), constant_values=FULL)
        return flat

    elimb, _ = kmers.extract_kmers(both, blen, sub_k + 1)
    occ = _flat_pad(elimb, occ_cap)

    cov = None
    if pop_bubbles > 0:
        if kcounts is None:
            row_counts = jnp.where(row_valid, 1, 0).astype(jnp.int32)
        else:
            row_counts = jnp.where(row_valid, kcounts, 0).astype(jnp.int32)
        rc2 = jnp.concatenate([row_counts, row_counts], axis=1)  # [G, 2M]
        nlimb, nval = kmers.extract_kmers(both, blen, sub_k)
        P1 = nlimb.shape[2]
        nkeys = _flat_pad(nlimb, occn_cap)
        val = nval.reshape(G, -1)
        wgt = jnp.broadcast_to(rc2[:, :, None],
                               (G, 2 * M, P1)).reshape(G, -1)
        if val.shape[1] < occn_cap:
            pad = occn_cap - val.shape[1]
            val = jnp.pad(val, ((0, 0), (0, pad)))
            wgt = jnp.pad(wgt, ((0, 0), (0, pad)))
        cov = (nkeys, val, wgt)
    return occ, cov


@functools.partial(jax.jit, static_argnames=(
    "settings", "max_unitigs", "max_len", "min_len", "pop_bubbles",
    "max_bubble_len", "node_cap", "edge_cap"))
def assemble_unitigs_multi(kstr_list, nk_list, kcnt_list, *, settings,
                           max_unitigs: int = 64, max_len: int = 1024,
                           min_len: int = 40, pop_bubbles: int = 0,
                           max_bubble_len: int | None = None,
                           node_cap: int, edge_cap: int):
    """ALL (k, sub_k) settings over a gap batch in ONE vmapped program.

    The reference runs one KMC+Velvet soup per setting per gap
    (/root/reference/assemble_gaps.py:96-122); the round-4 design ran
    one XLA program per setting. Here every (gap, setting) pair is one
    vmap lane with its sub_k as per-lane DATA: 6 settings batch into a
    single program whose sorts/gathers are 6x fatter (fewer, larger
    kernels).

    kstr_list/nk_list/kcnt_list: per-setting [G, M_s, k_s] / [G] /
    ([G, M_s] or None). node_cap/edge_cap: uniform static caps (max of
    the per-setting caps). Returns per-setting lists of
    (useq [G, mu, Lc], ulen, ucnt, n_nodes_raw, n_edges_raw).
    """
    S = len(settings)
    G = kstr_list[0].shape[0]
    # group settings by occurrence-row count so a (k, k-1) setting
    # (occ = 2M rows) is not padded to a (k, k-3) setting's 6M rows —
    # uniform padding measured ~25% slower than per-setting dispatch
    groups: dict[int, list[int]] = {}
    for i, (k, sk) in enumerate(settings):
        groups.setdefault(2 * kstr_list[i].shape[1] * (k - sk),
                          []).append(i)
    results: list = [None] * S
    for occ_cap, idxs in sorted(groups.items()):
        sub_set = [settings[i] for i in idxs]
        nl_pad = max(kmers.num_limbs(sk + 1) for _, sk in sub_set)
        occn_cap = max(2 * kstr_list[i].shape[1]
                       * (settings[i][0] - settings[i][1] + 1)
                       for i in idxs)
        sub_k_max = max(sk for _, sk in sub_set)

        occs, covs = [], []
        for i in idxs:
            k, sk = settings[i]
            occ, cov = _occurrence_prep(
                kstr_list[i], nk_list[i],
                None if kcnt_list is None else kcnt_list[i],
                k=k, sub_k=sk, nl_pad=nl_pad, occ_cap=occ_cap,
                occn_cap=occn_cap, pop_bubbles=pop_bubbles)
            occs.append(occ)
            covs.append(cov)
        occ_all = jnp.concatenate(occs, axis=0)    # [Sg*G, occ_cap, nl]
        sub_all = jnp.repeat(jnp.asarray([sk for _, sk in sub_set],
                                         jnp.int32), G)

        fn = functools.partial(
            _core_lane, sub_k_max=sub_k_max, max_unitigs=max_unitigs,
            max_len=max_len, min_len=min_len, pop_bubbles=pop_bubbles,
            max_bubble_len=max_bubble_len, node_cap=node_cap,
            edge_cap=edge_cap)
        if pop_bubbles > 0:
            cov_all = tuple(jnp.concatenate([c[j] for c in covs], axis=0)
                            for j in range(3))
            out = jax.vmap(lambda o, s, ck, cv, cw:
                           fn(o, s, (ck, cv, cw)))(occ_all, sub_all,
                                                   *cov_all)
        else:
            out = jax.vmap(lambda o, s: fn(o, s, None))(occ_all, sub_all)
        for j, i in enumerate(idxs):
            results[i] = tuple(x[j * G:(j + 1) * G] for x in out)
    return results


def assemble_unitigs(kstrings, n_kstrings, kcounts=None, *, k: int,
                     sub_k: int, max_unitigs: int = 64, max_len: int = 1024,
                     min_len: int = 40, pop_bubbles: int = 0,
                     max_bubble_len: int | None = None,
                     node_cap: int | None = None,
                     edge_cap: int | None = None):
    """Batched over gaps, one (k, sub_k) setting: kstrings [G, M, k],
    n_kstrings [G], kcounts optional [G, M]. Thin wrapper over
    assemble_unitigs_multi (the single shared core). When
    node_cap/edge_cap are omitted, provably-sufficient bounds are used
    (2E endpoint rows bound distinct nodes by construction) and only
    (seqs, lens, count) is returned — the capped form also returns
    (n_nodes_raw, n_edges_raw) for overflow detection."""
    M = kstrings.shape[1]
    occ = 2 * M * (k - sub_k)
    capped = node_cap is not None or edge_cap is not None
    ecap = occ if edge_cap is None else edge_cap
    ncap = 2 * ecap if node_cap is None else node_cap
    res = assemble_unitigs_multi(
        (kstrings,), (n_kstrings,),
        None if kcounts is None else (kcounts,),
        settings=((k, sub_k),), max_unitigs=max_unitigs,
        max_len=max_len, min_len=min_len, pop_bubbles=pop_bubbles,
        max_bubble_len=max_bubble_len, node_cap=ncap, edge_cap=ecap)[0]
    if capped:
        return res
    return res[:3]


def unpack_kmers_to_strings(limbs, k: int):
    """[..., P, nl] packed k-mers -> [..., P, k] int8 codes (FULL -> N)."""
    bases = [_kmer_base(limbs, i) for i in range(k)]
    res = jnp.stack(bases, axis=-1)
    invalid = jnp.all(limbs == FULL, axis=-1)
    return jnp.where(invalid[..., None], dna.N, res)
