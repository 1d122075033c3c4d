import numpy as np
import pytest

from gappadder import dna
from gappadder.ops import merge_engine
from gappadder.ops.merge_engine import MergeConfig


def _rand(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


def test_dedup_exact_and_revcomp(rng):
    a = _rand(rng, 200)
    contigs = [a, a.copy(), dna.revcomp(a), _rand(rng, 150)]
    keep = merge_engine.dedup_contigs(contigs, MergeConfig())
    assert keep == [0, 3]


def test_dedup_contained(rng):
    big = _rand(rng, 400)
    small = big[100:250].copy()
    keep = merge_engine.dedup_contigs([small, big], MergeConfig())
    assert keep == [1]


def test_dedup_keeps_distinct(rng):
    contigs = [_rand(rng, 300), _rand(rng, 300), _rand(rng, 120)]
    keep = merge_engine.dedup_contigs(contigs, MergeConfig())
    assert keep == [0, 1, 2]


def test_merge_two_overlapping(rng):
    truth = _rand(rng, 500)
    a = truth[:300].copy()
    b = truth[250:].copy()
    merged, infos = merge_engine.merge_contigs([a, b], MergeConfig())
    assert merged, "no merge found"
    best = max(merged, key=len)
    canon = min(best.tobytes(), dna.revcomp(best).tobytes())
    want = min(truth.tobytes(), dna.revcomp(truth).tobytes())
    assert canon == want


def test_merge_respects_strand(rng):
    truth = _rand(rng, 500)
    a = truth[:300].copy()
    b = dna.revcomp(truth[250:])     # second contig on other strand
    merged, _ = merge_engine.merge_contigs([a, b], MergeConfig())
    assert merged
    best = max(merged, key=len)
    canon = min(best.tobytes(), dna.revcomp(best).tobytes())
    want = min(truth.tobytes(), dna.revcomp(truth).tobytes())
    assert canon == want


def test_merge_three_chain(rng):
    truth = _rand(rng, 700)
    parts = [truth[:300].copy(), truth[250:520].copy(), truth[470:].copy()]
    merged, _ = merge_engine.merge_contigs(parts, MergeConfig())
    assert merged
    best = max(merged, key=len)
    canon = min(best.tobytes(), dna.revcomp(best).tobytes())
    want = min(truth.tobytes(), dna.revcomp(truth).tobytes())
    assert canon == want


@pytest.mark.parametrize("seed", range(8))
def test_merge_reconstructs_random_chains(seed):
    """Property: a truth split into random overlapping pieces (some
    reverse-complemented, shuffled) merges back to the full truth."""
    rng = np.random.default_rng(seed)
    n_pieces = int(rng.integers(2, 6))
    L = int(rng.integers(400, 900))
    truth = _rand(rng, L)
    cuts = np.sort(rng.choice(np.arange(60, L - 60), n_pieces - 1,
                              replace=False))
    bounds = [0] + list(cuts) + [L]
    pieces = []
    for i in range(n_pieces):
        s = bounds[i]
        e = bounds[i + 1]
        s2 = max(0, s - int(rng.integers(20, 50)))   # overlap prev piece
        p = truth[s2:e].copy()
        if rng.integers(0, 2):
            p = dna.revcomp(p)
        pieces.append(p)
    order = rng.permutation(n_pieces)
    merged, _ = merge_engine.merge_contigs([pieces[i] for i in order],
                                           MergeConfig())
    assert merged, f"no merge (seed={seed})"
    best = max(merged, key=len)
    canon = min(best.tobytes(), dna.revcomp(best).tobytes())
    want = min(truth.tobytes(), dna.revcomp(truth).tobytes())
    assert canon == want, (seed, len(best), L)


def test_merge_rejects_containment(rng):
    big = _rand(rng, 400)
    small = big[100:250].copy()
    merged, _ = merge_engine.merge_contigs([big, small], MergeConfig())
    # containment must not produce a "merge" longer than big
    assert all(len(m) <= len(big) for m in merged)


def test_merge_rejects_short_overlap(rng):
    a = _rand(rng, 200)
    b = np.concatenate([a[-8:], _rand(rng, 200)])  # only 8bp overlap < 12
    merged, _ = merge_engine.merge_contigs([a, b], MergeConfig())
    for m in merged:
        assert len(m) < len(a) + len(b) - 4


# ---- adversarial graphs vs brute-force path enumeration ------------------

def _canon_bytes(s):
    return min(s.tobytes(), dna.revcomp(s).tobytes())


@pytest.mark.parametrize("seed", range(6))
def test_merge_branching_decoys_vs_bruteforce_optimum(seed):
    """Adversarial branching: truth windows plus decoy contigs that share
    an overlap with a middle window but then diverge. The true longest
    path (known by construction: it reconstructs the full truth) must be
    found despite the competing out-edges — the per-node longest-path DP
    must match brute-force simple-path enumeration on the DAG
    (ContigsCompactor FindSimplePathsTopSort semantics,
    ContigsCompactor.cpp:773-983)."""
    rng = np.random.default_rng(1000 + seed)
    L = int(rng.integers(500, 800))
    truth = _rand(rng, L)
    # tile truth with 40-60bp overlaps
    bounds = [0]
    while bounds[-1] < L - 180:
        bounds.append(bounds[-1] + int(rng.integers(120, 180)))
    bounds.append(L)
    windows = []
    for i in range(len(bounds) - 1):
        s = max(0, bounds[i] - (int(rng.integers(40, 60)) if i else 0))
        windows.append(truth[s:bounds[i + 1]].copy())
    # decoys: share a window's 45bp suffix, then diverge for LONGER than
    # max_clip_len (otherwise clip slack lets the decoy legitimately
    # re-join the chain, ContigsMerger -y semantics) but shorter than
    # the remaining truth, so the truth path is the unique optimum
    decoys = []
    for w in windows[:-1][:2]:
        decoys.append(np.concatenate([w[-45:], _rand(rng, 80)]))
    # noise contigs with no overlaps at all
    noise = [_rand(rng, 100) for _ in range(2)]
    contigs = windows + decoys + noise
    order = rng.permutation(len(contigs))
    merged, infos = merge_engine.merge_contigs(
        [contigs[i] for i in order], MergeConfig())
    assert merged, f"no merge (seed={seed})"
    best = max(merged, key=len)
    assert _canon_bytes(best) == _canon_bytes(truth), (seed, len(best), L)
    # nothing can beat the known optimum
    assert all(len(m) <= L for m in merged)


def test_merge_two_cycle_terminates_and_is_valid(rng):
    """a = X+Y, b = Y+X creates a 2-cycle (a->b and b->a edges); cycle
    edges must be dropped deterministically (no hang), and any emitted
    merge must be a real splice of the inputs."""
    X, Y = _rand(rng, 150), _rand(rng, 150)
    a = np.concatenate([X, Y])
    b = np.concatenate([Y, X])
    merged, infos = merge_engine.merge_contigs([a, b], MergeConfig())
    # one direction survives: a+b or b+a spliced over the 150bp overlap
    for m in merged:
        assert len(m) <= len(a) + len(b)
    if merged:
        best = max(merged, key=len)
        want1 = np.concatenate([X, Y, X])   # a over b (Y overlap)
        want2 = np.concatenate([Y, X, Y])   # b over a (X overlap)
        assert _canon_bytes(best) in (_canon_bytes(want1),
                                      _canon_bytes(want2))


def test_merge_self_cycle_revcomp_palindrome_safe(rng):
    """A contig whose tail overlaps its own twin's head (inverted
    repeat) must not loop forever or emit garbage longer than 2x."""
    core = _rand(rng, 120)
    ir = np.concatenate([core, dna.revcomp(core[:40])])
    merged, _ = merge_engine.merge_contigs([ir, _rand(rng, 100)],
                                           MergeConfig())
    for m in merged:
        assert len(m) <= 2 * len(ir)


@pytest.mark.parametrize("seed", range(4))
def test_merge_diamond_reconvergence(seed):
    """Diamond: prefix P, two variant middles M1/M2, suffix S. Both
    P+M1+S and P+M2+S are valid simple paths; the DP must emit a merge
    equal to one full variant (P and S nodes can each be used once per
    path), never a chimera shorter than a full variant."""
    rng = np.random.default_rng(2000 + seed)
    P, S = _rand(rng, 200), _rand(rng, 200)
    M1, M2 = _rand(rng, 150), _rand(rng, 150)
    v1 = np.concatenate([P, M1, S])
    v2 = np.concatenate([P, M2, S])
    # windows of each variant: P+head(M), M+head(S) -> shares P and S
    contigs = [
        np.concatenate([P, M1[:50]]), np.concatenate([M1, S[:50]]),
        np.concatenate([P, M2[:50]]), np.concatenate([M2, S[:50]]),
        S,
    ]
    merged, _ = merge_engine.merge_contigs(contigs, MergeConfig())
    assert merged, f"no merge (seed={seed})"
    best = max(merged, key=len)
    assert _canon_bytes(best) in (_canon_bytes(v1), _canon_bytes(v2)), (
        seed, len(best), len(v1))


def _brute_force_reference_paths(N, edges, cfg):
    """Oracle for enumerate_paths: literal-but-slow reference semantics
    (GraphUtils.cpp:625-860). Enumerates ALL rank-monotone simple paths
    per (root, end), keeps the min-total-weight one (weight=-overlap),
    then applies the per-root top-k and revcomp dedup identically."""
    import itertools
    adj = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    sccs = merge_engine._tarjan_scc(N, adj)
    scc_of, rank = {}, {}
    r = 0
    for ci, comp in enumerate(sccs):
        for v in comp:
            scc_of[v] = ci
            rank[v] = r
            r += 1

    def candidates(start):
        cand = set(range(N))
        for u in range(N):
            for v in adj.get(u, ()):
                if scc_of[u] != scc_of[v]:
                    cand.discard(v if start else u)
        for comp in sccs:
            if len(comp) <= 1:
                continue
            all_in = all(v in cand for v in comp)
            keep = comp[0] if start else comp[-1]
            for v in comp:
                if v != keep or not all_in:
                    cand.discard(v)
        return sorted(cand, key=lambda v: rank[v])

    roots, ends = candidates(True), set(candidates(False))

    def all_paths_from(u, seen):
        yield (u,)
        for v in adj.get(u, ()):
            if rank[v] <= rank[u] or v in seen:
                continue
            for rest in all_paths_from(v, seen | {v}):
                yield (u,) + rest

    all_out, seen_paths = [], set()
    for root in roots:
        best = {}
        for p in all_paths_from(root, {root}):
            if p[-1] not in ends:
                continue
            w = sum(-edges[(a, b)][0] for a, b in zip(p, p[1:]))
            # reference DP: first strictly-better path wins; emulate by
            # (weight, rank-order path) minimum
            key = p[-1]
            if key not in best or w < best[key][0]:
                best[key] = (w, p)
        found = sorted((p for _w, p in best.values()),
                       key=lambda p: (-len(p), p))
        for num_out, p in enumerate(found):
            if num_out > merge_engine.MAX_PATHS_PER_ROOT:
                break
            if p not in seen_paths:
                seen_paths.add(p)
                all_out.append(p)
    ordered = sorted(all_out)
    pos = {p: i for i, p in enumerate(ordered)}
    out = []
    for p in ordered:
        q = tuple(v ^ 1 for v in reversed(p))
        if q in pos and pos[q] < pos[p]:
            continue
        out.append(p)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_enumerate_paths_matches_bruteforce(seed):
    """Random small digraphs (with twins + cycles): enumerate_paths
    must equal the literal reference-semantics brute force."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    N = 2 * n
    cfg = MergeConfig()
    edges = {}
    for _ in range(int(rng.integers(1, 2 * N))):
        a, b = int(rng.integers(0, N)), int(rng.integers(0, N))
        if a >> 1 == b >> 1:
            continue
        edges[(a, b)] = (int(rng.integers(10, 200)), 0)
    if not edges:
        return
    got = merge_engine.enumerate_paths(N, edges, cfg)
    want = _brute_force_reference_paths(N, edges, cfg)
    assert got == want


def test_merge_emits_multiple_branch_paths(rng):
    """VERDICT r1 #4(merge): branching graphs must yield one merged
    contig per (root, end) pair like the reference — the old
    single-best-predecessor DP emitted at most one path per sink."""
    core = _rand(rng, 300)
    pre_a, pre_b = _rand(rng, 200), _rand(rng, 200)
    suf_d, suf_e = _rand(rng, 200), _rand(rng, 200)
    ov = 60
    A = np.concatenate([pre_a, core[:ov]])
    B = np.concatenate([pre_b, core[:ov]])
    C = core
    D = np.concatenate([core[-ov:], suf_d])
    E = np.concatenate([core[-ov:], suf_e])
    merged, infos = merge_engine.merge_contigs([A, B, C, D, E],
                                               MergeConfig())
    texts = {dna.decode(m) for m in merged}
    for pre in (pre_a, pre_b):
        for suf in (suf_d, suf_e):
            want = dna.decode(np.concatenate([pre, core, suf]))
            rc = dna.decode(dna.revcomp(np.concatenate([pre, core, suf])))
            assert want in texts or rc in texts, (len(texts))
    assert len(merged) >= 4


def test_out_edge_cap_changes_answer_and_warns(rng):
    """VERDICT r2 #10: the max_out_edges fidelity knob. On a branching
    graph (one upstream contig overlapping two alternatives), capping
    out-edges at 1 drops a merged path — the warning must fire and the
    output must visibly differ from the unbounded (reference-exact)
    default. Reference behavior is the unbounded O(n^2) pair scan
    (ContigsCompactor.cpp:992-1100)."""
    from gappadder.utils import log as gtlog
    # complete bipartite 2x2 around a shared 60bp junction: each A has
    # 2 out-edges and each B_R twin has 2 — capping at 1 cuts the
    # (A2, B2) pair in BOTH strand directions, losing that merge
    # (star-shaped graphs are rescued by their twin edges; this isn't)
    J = _rand(rng, 60)
    A1 = np.concatenate([_rand(rng, 200), J])
    A2 = np.concatenate([_rand(rng, 200), J])
    B1 = np.concatenate([J, _rand(rng, 200)])
    B2 = np.concatenate([J, _rand(rng, 200)])
    contigs = [A1, A2, B1, B2]

    full = merge_engine.merge_contigs(contigs, MergeConfig())[0]
    assert len(full) >= 4          # all four A_i-B_j merges exist

    gtlog.reset_cap_events()
    capped = merge_engine.merge_contigs(
        contigs, MergeConfig(max_out_edges=1))[0]
    assert gtlog.cap_events("merge_out_edges_truncated") > 0
    assert len(capped) < len(full)  # the cap changed the answer


def test_candidate_cap_changes_answer_and_warns(rng):
    """max_candidates truncation on a many-pair input: warns and drops
    later pairs' merges."""
    from gappadder.utils import log as gtlog
    core = _rand(rng, 300)
    ov = 60
    contigs = [core] + [np.concatenate([core[-ov:], _rand(rng, 150)])
                        for _ in range(4)]
    full = merge_engine.merge_contigs(contigs, MergeConfig())[0]
    assert len(full) >= 4

    gtlog.reset_cap_events()
    capped = merge_engine.merge_contigs(
        contigs, MergeConfig(max_candidates=3))[0]
    assert gtlog.cap_events("merge_candidates_truncated") > 0
    assert len(capped) < len(full)


# ---------------------------------------------------------------------------
# batched device Evaluate + multi-gap refine parity (round-4)
# ---------------------------------------------------------------------------

def _eval_cases(rng, n_pairs=60, lmax=300):
    pairs = []
    for i in range(n_pairs):
        n = int(rng.integers(5, lmax))
        m = int(rng.integers(5, lmax))
        s1 = _rand(rng, n)
        s2 = _rand(rng, m)
        if i % 2 == 0:  # bias toward real overlaps, some with errors
            k = int(rng.integers(4, min(n, m)))
            s2[:k] = s1[-k:]
            if rng.random() < 0.3:
                s2[int(rng.integers(0, k))] ^= 1
        pairs.append((s1, s2))
    return pairs


@pytest.mark.parametrize("relax", [False, True])
def test_evaluate_pairs_device_matches_host_oracle(rng, relax):
    """The device Evaluate kernel (fill + end scan + winner + endpoint
    flags) is bit-identical to the host evaluate_pair oracle
    (ContigsCompactor.cpp:1572-1874 semantics)."""
    pairs = _eval_cases(rng)
    for cfg in (MergeConfig(), MergeConfig(max_clip_len=7,
                                           min_overlap_len=5)):
        got = merge_engine.evaluate_pairs(pairs, cfg, relax=relax)
        for (s1, s2), g in zip(pairs, got):
            w = merge_engine.evaluate_pair(s1, s2, cfg, relax=relax)
            assert (g.code, g.score, g.pos_row, g.pos_col, g.nclip,
                    g.bcontained, g.is_containment) == \
                   (w.code, w.score, w.pos_row, w.pos_col, w.nclip,
                    w.bcontained, w.is_containment)
            assert np.array_equal(g.merged, w.merged)


def _chain_contigs(rng, n_contigs, seg=60, ov=25):
    total = n_contigs * seg + ov
    truth = _rand(rng, total)
    out = []
    for i in range(n_contigs):
        out.append(truth[i * seg: i * seg + seg + ov].copy())
    rng.shuffle(out)
    return out


def test_merge_contigs_multi_matches_per_gap(rng):
    """Batching many gaps' merges into shared device dispatches gives
    per-gap results identical to merge_contigs one gap at a time."""
    cfg = MergeConfig()
    gaps = []
    for gi in range(6):
        ncont = int(rng.integers(2, 5))
        contigs = _chain_contigs(rng, ncont)
        if gi % 3 == 2:          # some gaps with unrelated contigs
            contigs.append(_rand(rng, 120))
        gaps.append(contigs)
    gaps.append([])              # empty gap in the batch
    multi = merge_engine.merge_contigs_multi(gaps, cfg)
    for contigs, (m_merged, m_infos) in zip(gaps, multi):
        s_merged, s_infos = merge_engine.merge_contigs(contigs, cfg)
        assert m_infos == s_infos
        assert len(m_merged) == len(s_merged)
        for a, b in zip(m_merged, s_merged):
            assert np.array_equal(a, b)


def test_dedup_contigs_multi_matches_per_gap(rng):
    cfg = MergeConfig()
    gaps = []
    for _ in range(5):
        a = _rand(rng, 200)
        contigs = [a, a.copy(), dna.revcomp(a), _rand(rng, 150),
                   a[20:180].copy()]
        rng.shuffle(contigs)
        gaps.append(contigs)
    gaps.append([])
    multi = merge_engine.dedup_contigs_multi(gaps, cfg)
    for contigs, got in zip(gaps, multi):
        assert got == merge_engine.dedup_contigs(contigs, cfg)


def test_refine_contigs_multi_matches_per_gap(rng):
    from gappadder.pipeline import run as run_mod
    cfg = MergeConfig()
    items = []
    for gi in range(5):
        contigs = _chain_contigs(rng, int(rng.integers(2, 4)))
        contigs.append(contigs[0].copy())         # a duplicate to drop
        names = [f"c{gi}_{i}" for i in range(len(contigs))]
        items.append((contigs, names))
    multi = run_mod.refine_contigs_multi(items, cfg)
    for (contigs, names), (mc, mn, mi) in zip(items, multi):
        sc, sn, si = run_mod.refine_contigs(contigs, names, cfg)
        assert mn == sn and mi == si
        assert len(mc) == len(sc)
        for a, b in zip(mc, sc):
            assert np.array_equal(a, b)


def test_refine_merge_info_reporting_semantics(rng):
    """refine_contigs reports merge provenance with three distinct
    states (ADVICE r3): list of lines when a merge produced contigs,
    [] when the merger RAN but merged nothing (callers must then clear
    stale provenance, like the binary rewriting its -o file empty),
    and None when the merge step did not run at all (no contigs after
    dedup, or the >1MB size guard)."""
    from gappadder.pipeline import run as run_mod
    from gappadder.pipeline.run import MERGE_SKIP_BASES
    cfg = MergeConfig()

    # chain that merges -> non-empty lines
    chain = _chain_contigs(rng, 3)
    _, _, il = run_mod.refine_contigs(
        chain, [f"c{i}" for i in range(len(chain))], cfg)
    assert il and all(l.startswith("NEW_CONTIG_MERGE_") for l in il)

    # disjoint contigs: merger runs, merges nothing -> [] (not None)
    parts = [_rand(rng, 100), _rand(rng, 120)]
    _, _, il = run_mod.refine_contigs(parts, ["a", "b"], cfg)
    assert il == [] and il is not None

    # no contigs -> merge never ran -> None
    _, _, il = run_mod.refine_contigs([], [], cfg)
    assert il is None

    # size guard: total > 1MB skips merging entirely -> None
    # (single-base contigs: their 10-mer sketches share nothing, so
    # the dedup pair screen stays empty and the test stays fast)
    big = [np.full(MERGE_SKIP_BASES // 2 + 10, b, np.int8)
           for b in (0, 1)]
    _, _, il = run_mod.refine_contigs(big, ["x", "y"], cfg)
    assert il is None
