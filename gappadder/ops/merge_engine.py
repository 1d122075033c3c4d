"""Contig dedup + overlap-graph merge — the TERefiner(-U/-P/-K) and
ContigsMerger replacement (L2).

Per gap (batched across a gap list; all DP scoring on device):

DEDUP (Refiner.removeDupRepeatsOfOneContigSet / removeContainedContigs,
/root/reference/TERefiner/refiner.cpp:587-801):
  exact duplicates dropped by content hash; near-duplicate/contained
  contigs found by sketch-pruned local SW — a contig whose best local
  alignment onto another covers >= `cutoff` of its length is dropped
  when the other is longer (containment) or has a smaller index
  (duplicate tie-break, the reference's qname>rname order).

MERGE (ContigsCompactor::CompactVer3,
/root/reference/ContigsCompactor-v0.2.0/ContigsMerger/ContigsCompactor.cpp:773-983):
  1. revcomp twin per contig;
  2. quick-check: pairs sharing >= min_support 10-mers between A's tail
     window and B's head window (QuickCheckerContigsMatch, :1982-2096)
     — here a hashed-bitset intersection;
  3. overlap DP (Evaluate, :1572-1874): match +1, mismatch/indel -2
     (the pipeline's -i1 -2 -i2 -2), free end gaps, ends scanned with
     up to maxOverlapClipLen=50 slack -> the SW kernel's overlap mode
     with end_slack;
  4. IsScoreSignificant (:1876-1976): overlap >= min frac / len,
     >= 5 bp extension (containment rejected), score >=
     overlap*(1-fracScoreLoss);
  5. digraph of A->B edges weighted -overlap; Tarjan SCC condensation
     gives the topological rank (GraphUtils.cpp:1028-1073); path roots/
     ends are nodes with no cross-SCC incoming/outgoing edges
     (FindSimplePathsTopSortStart, :1258-1340); per root, a min-weight
     (= max total overlap) path DP over rank order ignoring back-edges
     yields one path per (root, end) pair (FindSimplePathsTopSortFrom,
     :774-860); per root the longest-by-node-count paths are kept
     (FindSimplePathsTopSort, :625-771);
  6. path splicing: merged = A[:qstart] + B at each edge (the
     reference's traceback keeps seq2's characters in the overlap);
  7. revcomp-duplicate merged paths removed (RemoveDupRevCompPaths).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import dna
from ..utils import log
from . import sw_host
from .sw_host import SWParams

MERGE_PARAMS = SWParams(match=1, mismatch=-2, gap_open=2, gap_extend=2)
SKETCH_WORDS = 64                   # 2048-bit 10-mer sketch


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    frac_score_loss: float = 0.4    # -s
    min_frac_overlap: float = 0.005  # -c default
    min_overlap_len: int = 12       # -x
    max_clip_len: int = 50          # -y
    min_overlap_len_scaffold: int = 6  # -z default
    kmer_len: int = 10              # -k
    min_support_kmer: int = 1       # -m
    # -p2 maxCountContigInPath: per-root path-count cap passed to
    # FindSimplePathsTopSort (ContigsMerger/main.cpp:192-198 ->
    # ContigsCompactor.cpp:907); the reference's loop emits cap+1
    # paths (numOut > cap break, GraphUtils.cpp:733-748) — kept.
    max_paths_per_root: int = 20
    # -p1 maxContigPathLen and -u supportPairsCutoff are ACCEPTED by
    # the reference CLI but DEAD in CompactVer3: -p1 feeds only the
    # commented-out FindSimplePaths/FindSimplePathsBoundedLength calls
    # (ContigsCompactor.cpp:905-906) and -u only the commented-out
    # loadScaffoldInfo hook (:1180). Carried here so configs using
    # them round-trip; they change nothing, same as the binary.
    max_contig_path_len: int = -1   # -p1 (no effect in CompactVer3)
    support_pairs_cutoff: int = 2   # -u  (no effect in CompactVer3)
    window: int = 1000              # dedup sketch window size
    max_paths_per_gap: int = 32
    dedup_cutoff: float = 0.99      # MergeContigs.py:73-99
    # DP-bill bounds on fragmented inputs (warn loudly when they bite;
    # the reference pays the full O(n^2) pair DP instead). Defaults
    # keep reference-exact behavior: max_out_edges=0 = unbounded.
    max_candidates: int = 4096
    max_out_edges: int = 0


def _kmer_hashes(seq: np.ndarray, k: int) -> np.ndarray:
    """Rolling k-mer hash values (host, vectorized)."""
    s = np.asarray(seq, np.uint64)
    n = len(s) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    h = np.zeros(n, np.uint64)
    for j in range(k):
        h = h * np.uint64(1099511628211) + s[j:j + n] + np.uint64(1)
    return h


def _sketch(seq: np.ndarray, k: int) -> np.ndarray:
    """Bitset sketch of a sequence's k-mer hash set."""
    h = _kmer_hashes(seq, k) % np.uint64(SKETCH_WORDS * 32)
    out = np.zeros(SKETCH_WORDS, np.uint32)
    np.bitwise_or.at(out, (h // 32).astype(np.int64),
                     (np.uint32(1) << (h % 32).astype(np.uint32)))
    return out


def _shared_kmers(sk_a: np.ndarray, sk_b: np.ndarray) -> int:
    return int(np.bitwise_count(sk_a & sk_b).sum())


def _shared_matrix(sk_a: np.ndarray, sk_b: np.ndarray) -> np.ndarray:
    """Pairwise shared-bit counts: [A, W]uint32 x [B, W] -> [A, B].

    Word-level popcount in row blocks (32x less data than the old
    unpackbits bit-matrix product; blocks bound peak memory)."""
    A, W = sk_a.shape
    B = sk_b.shape[0]
    out = np.empty((A, B), np.int32)
    step = max(1, (1 << 24) // max(B * W, 1))
    for i in range(0, A, step):
        blk = sk_a[i:i + step, None, :] & sk_b[None, :, :]
        out[i:i + step] = np.bitwise_count(blk).sum(axis=2,
                                                    dtype=np.int32)
    return out


def _sw_batch_np(queries, targets, mode, params, end_slack=0):
    """Run a ragged list of (q, t) pairs through the device kernel."""
    from .swutil import sw_ragged
    return sw_ragged(queries, targets, params, mode, end_slack=end_slack)


def dedup_contigs_multi(contig_lists, cfg: MergeConfig):
    """Batched dedup over many gaps' contig lists: one device SW batch
    for ALL gaps' candidate pairs (decisions stay per-gap and match
    dedup_contigs exactly). Returns a keep-index list per gap."""
    G = len(contig_lists)
    keeps: list[list[bool]] = []
    pend: list[tuple[int, int, int]] = []    # (gap, i, j) in-gap order
    for contigs in contig_lists:
        n = len(contigs)
        keep = [True] * n
        keeps.append(keep)
        if n <= 1:
            continue
        # exact dups
        seen: dict[bytes, int] = {}
        for i, c in enumerate(contigs):
            key = c.tobytes()
            rkey = dna.revcomp(c).tobytes()
            if key in seen or rkey in seen:
                keep[i] = False
            else:
                seen[key] = i
        # sketch-pruned near-dup / containment (vectorized pair screen)
        sketches = np.stack([_sketch(c, cfg.kmer_len) for c in contigs])
        shared = _shared_matrix(sketches, sketches)
        lens = np.array([len(c) for c in contigs])
        keep_arr = np.array(keep)
        need = np.minimum(np.maximum(
            (0.5 * np.minimum(lens, cfg.window) - cfg.kmer_len), 1), 32)
        cand = (shared >= need[:, None]) & keep_arr[:, None] \
            & keep_arr[None, :] & (lens[:, None] <= lens[None, :]) & \
            ~np.eye(n, dtype=bool)
        gi = len(keeps) - 1
        pend += [(gi, int(i), int(j)) for i, j in zip(*np.nonzero(cand))]
    if pend:
        qs = [contig_lists[g][i] for g, i, _ in pend]
        ts = [contig_lists[g][j] for g, _, j in pend]
        # check both strands: query vs target and revcomp
        s1, _, _ = _sw_batch_np(qs, ts, "local", SWParams(1, -4, 7, 1))
        rs = [dna.revcomp(q) for q in qs]
        s2, _, _ = _sw_batch_np(rs, ts, "local", SWParams(1, -4, 7, 1))
        for (g, i, j), sc1, sc2 in zip(pend, s1, s2):
            keep = keeps[g]
            if not (keep[i] and keep[j]):
                continue
            sc = max(sc1, sc2)
            li = len(contig_lists[g][i])
            lj = len(contig_lists[g][j])
            if sc >= cfg.dedup_cutoff * li:
                if li < lj:                 # contained (-K)
                    keep[i] = False
                elif lj * (1.0 - cfg.dedup_cutoff) >= abs(li - lj) and i > j:
                    keep[i] = False         # near-dup (-P), drop higher idx
    return [[i for i in range(len(k)) if k[i]] for k in keeps]


def dedup_contigs(contigs: list[np.ndarray], cfg: MergeConfig):
    """Indices of contigs to KEEP after duplicate/containment removal."""
    return dedup_contigs_multi([contigs], cfg)[0]


# Evaluate return codes (ContigsCompactor.cpp:1566-1570)
OVERLAP_SMALLER = 0
OVERLAP_IN_RANGE = 1
OVERLAP_LARGER_MINLEN = 2


@dataclasses.dataclass
class EvalResult:
    """One pair evaluation (reference Evaluate semantics)."""
    code: int
    score: int
    pos_row: int        # DP end row (bases of seq1 consumed)
    pos_col: int        # DP end col (bases of seq2 consumed)
    nclip: int          # winning end-clip c
    bcontained: bool    # traceback reached the start of the ending seq
    is_containment: bool  # the (weaker) edge-veto condition
    merged: np.ndarray  # SetMergedStringConcat result (empty on code 0)

    def overlap_size(self, sz1: int, sz2: int) -> int:
        # GetOverlapSize (ContigsCompactor.h:51)
        return sz1 + sz2 - self.nclip - len(self.merged)


def _overlap_H(s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """Reference Evaluate DP: free start on both sequences, linear
    gaps, raw character equality (N matches N — ContigsCompactor.cpp
    :1640-1644 compares chars directly). Anti-diagonal vectorized."""
    q = np.asarray(s1, np.int64)
    t = np.asarray(s2, np.int64)
    n, m = len(q), len(t)
    mm = MERGE_PARAMS.mismatch
    ind = -MERGE_PARAMS.gap_open       # linear indel (-i2)
    H = np.zeros((n + 1, m + 1), np.int64)
    for d in range(2, n + m + 1):
        ilo = max(1, d - m)
        ihi = min(n, d - 1)
        if ilo > ihi:
            continue
        i = np.arange(ilo, ihi + 1)
        j = d - i
        s = np.where(q[i - 1] == t[j - 1], MERGE_PARAMS.match, mm)
        H[i, j] = np.maximum(H[i - 1, j - 1] + s,
                             np.maximum(H[i - 1, j] + ind,
                                        H[i, j - 1] + ind))
    return H


def _overlap_H_batch(pairs_seqs):
    """Batched _overlap_H over many (s1, s2) pairs: pads to the bucket
    max, fills ALL matrices in one anti-diagonal sweep, returns each
    pair's trimmed [n+1, m+1] view.  Padding uses distinct sentinels
    per side so padded cells always score as mismatch; they sit at
    higher indices than any true cell so the true region is
    bit-identical to the per-pair fill."""
    B = len(pairs_seqs)
    n_max = max(len(a) for a, _ in pairs_seqs)
    m_max = max(len(b) for _, b in pairs_seqs)
    q = np.full((B, n_max), -1, np.int32)
    t = np.full((B, m_max), -2, np.int32)
    for b, (s1, s2) in enumerate(pairs_seqs):
        q[b, :len(s1)] = s1
        t[b, :len(s2)] = s2
    mm = np.int32(MERGE_PARAMS.mismatch)
    ind = np.int32(-MERGE_PARAMS.gap_open)
    H = np.zeros((B, n_max + 1, m_max + 1), np.int32)
    for d in range(2, n_max + m_max + 1):
        ilo = max(1, d - m_max)
        ihi = min(n_max, d - 1)
        if ilo > ihi:
            continue
        i = np.arange(ilo, ihi + 1)
        j = d - i
        s = np.where(q[:, i - 1] == t[:, j - 1],
                     np.int32(MERGE_PARAMS.match), mm)
        H[:, i, j] = np.maximum(H[:, i - 1, j - 1] + s,
                                np.maximum(H[:, i - 1, j] + ind,
                                           H[:, i, j - 1] + ind))
    return [H[b, :len(s1) + 1, :len(s2) + 1]
            for b, (s1, s2) in enumerate(pairs_seqs)]


# bucket batches of surviving pairs to <= this many H cells at a time
# (int32), trading peak memory against per-pair Python sweep overhead
_BATCH_CELL_BUDGET = 64 << 20


def _eval_code(n: int, m: int, best: int, pr: int, pc: int, nc: int,
               cfg: MergeConfig) -> int:
    """IsScoreSignificant (ContigsCompactor.cpp:1876-1976)."""
    ov0 = min(n, m)
    ov1 = pc if pr + nc == n else ov0
    ov2 = pr if pc + nc == m else ov0
    ov = min(ov0, ov1, ov2)
    if ov < n * cfg.min_frac_overlap and ov < m * cfg.min_frac_overlap:
        return OVERLAP_SMALLER
    if pr + nc == n and pc + 5 - 1 >= m:
        return OVERLAP_SMALLER               # no >=5bp extension
    if pc + nc == m and pr + 5 - 1 >= n:
        return OVERLAP_SMALLER
    if best < ov * (1.0 - cfg.frac_score_loss):
        return OVERLAP_SMALLER
    if ov < cfg.min_overlap_len_scaffold:
        return OVERLAP_SMALLER
    if ov < cfg.min_overlap_len:
        return OVERLAP_IN_RANGE
    return OVERLAP_LARGER_MINLEN


def _finish_eval(s1, s2, best, pr, pc, nc, ends_i0: bool, ends_j0: bool,
                 code: int) -> EvalResult:
    """Containment flags + merged string, given the winning end cell
    and the traceback ENDPOINT flags (i==0 / j==0 at the stop cell)."""
    n, m = len(s1), len(s2)
    bcontained = (pr + nc == n and ends_i0) or (pc + nc == m and ends_j0)
    # edge-veto containment (IsContainment, ContigsCompactor.cpp:
    # 155-159): deliberately weaker — a prefix-contained seq1 with
    # posColEnd == len1 does NOT veto the edge (len1 < posColEnd fails)
    is_containment = bcontained and (
        (pr + nc == n and n < pc) or (pc + nc == m and m < pr))

    # ---- merged string = SetMergedStringConcat (:108-153) ---------------
    if bcontained and pr + nc == n and n < m:
        merged = np.asarray(s2, np.int8)
    elif bcontained and pc + nc == m and m < n:
        merged = np.asarray(s1, np.int8)
    elif pr + nc == n:
        merged = np.concatenate([s1[:n - nc], s2[pc:]]).astype(np.int8)
    else:
        merged = np.concatenate([s2[:m - nc], s1[pr:]]).astype(np.int8)
    return EvalResult(code, best, pr, pc, nc, bcontained,
                      is_containment, merged)


def evaluate_pair(s1: np.ndarray, s2: np.ndarray, cfg: MergeConfig,
                  relax: bool = False, H=None) -> EvalResult:
    """EXACT reference pair evaluation (ContigsCompactor::Evaluate,
    ContigsCompactor.cpp:1572-1874 + IsScoreSignificant :1876-1976):
    one DP per unordered pair; the best clipped border cell (scanned
    c = 0..max_clip_len, column before row, ascending index, strict
    improvement) decides direction, ends, containment and the merged
    string; relax skips the significance check (FormMergedSeqFromPath
    mode).  H: optional precomputed DP matrix (_overlap_H_batch).

    This is the host oracle; the production path is evaluate_pairs
    (batched device kernel, bit-identical)."""
    if H is None:
        H = _overlap_H(s1, s2)
    n, m = len(s1), len(s2)
    best = -(1 << 60)
    pr = pc = nc = -1
    for c in range(cfg.max_clip_len + 1):
        icol = m - c
        if icol >= 0:
            i = int(np.argmax(H[:, icol]))      # first max = lowest row
            if int(H[i, icol]) > best:
                best, pr, pc, nc = int(H[i, icol]), i, icol, c
        irow = n - c
        if irow >= 0:
            j = int(np.argmax(H[irow, :]))
            if int(H[irow, j]) > best:
                best, pr, pc, nc = int(H[irow, j]), irow, j, c

    code = OVERLAP_LARGER_MINLEN
    if not relax:
        code = _eval_code(n, m, best, pr, pc, nc, cfg)
        if code == OVERLAP_SMALLER:           # early return, no traceback
            return EvalResult(code, best, pr, pc, nc, False, False,
                              np.zeros(0, np.int8))

    # ---- traceback start -> endpoint flags ------------------------------
    # (only the walk's endpoint matters: the reference's
    # traceback-merged string is DEAD CODE — SetMergedString is
    # commented out at ContigsCompactor.cpp:1847; GetMerged() returns
    # the SetMergedStringConcat form in _finish_eval)
    i, j = pr, pc
    mm = MERGE_PARAMS.mismatch
    ind = -MERGE_PARAMS.gap_open
    while i > 0 and j > 0:
        s = MERGE_PARAMS.match if s1[i - 1] == s2[j - 1] else mm
        d = H[i - 1, j - 1] + s
        u = H[i - 1, j] + ind
        lf = H[i, j - 1] + ind
        # stored pointer preference: diag unless up strictly greater
        # unless left strictly greater (ContigsCompactor.cpp:1695-1711)
        if lf > max(d, u):
            j -= 1
        elif u > d:
            i -= 1
        else:
            i -= 1
            j -= 1
    return _finish_eval(s1, s2, best, pr, pc, nc, i == 0, j == 0, code)


def evaluate_pairs(pairs_seqs, cfg: MergeConfig,
                   relax: bool = False) -> list[EvalResult]:
    """Batched Evaluate over many (s1, s2) pairs: the WHOLE DP — fill,
    end scan, winner selection, traceback-endpoint flags — runs in the
    device kernel (ops/evaluate_dp.py), one dispatch + one small
    readback per shape bucket; the host only applies the significance
    code and concatenates the merged string. Bit-identical to
    evaluate_pair on every pair (tested)."""
    from . import evaluate_dp
    res = evaluate_dp.eval_pairs_device(
        pairs_seqs, cfg.max_clip_len, match=MERGE_PARAMS.match,
        mismatch=MERGE_PARAMS.mismatch, ind=-MERGE_PARAMS.gap_open)
    out: list[EvalResult] = []
    for (s1, s2), row in zip(pairs_seqs, res):
        best, pr, pc, nc, ei0, ej0 = (int(x) for x in row)
        n, m = len(s1), len(s2)
        code = (OVERLAP_LARGER_MINLEN if relax
                else _eval_code(n, m, best, pr, pc, nc, cfg))
        if code == OVERLAP_SMALLER:
            out.append(EvalResult(code, best, pr, pc, nc, False, False,
                                  np.zeros(0, np.int8)))
        else:
            out.append(_finish_eval(s1, s2, best, pr, pc, nc,
                                    bool(ei0), bool(ej0), code))
    return out


def merge_info_lines(names: list[str], infos: list[list[int]]):
    """Reference .merge.info lines (OutputContigsInfoVer2,
    ContigsCompactor.cpp:1545-1563): 'NEW_CONTIG_MERGE_<i>  <members>'
    where members are the path's contig names, each preceded by one
    space, revcomp twins suffixed _R (CompactVer3's twin naming).
    Numbering starts at 1 — the binary's `static int contigNumNext = 1`
    (ContigsCompactor.cpp:929-960)."""
    out = []
    for i, path in enumerate(infos):
        mem = "".join(f" {names[v // 2]}{'_R' if v & 1 else ''}"
                      for v in path)
        out.append(f"NEW_CONTIG_MERGE_{i + 1}  {mem}")
    return sorted(out)  # the reference's map<string,...> iteration order


def merge_graph_gml(names: list[str], graph: dict) -> str:
    """The reference's tmp.gml dump of the merge overlap graph
    (AbstractGraph::OutputGML, GraphUtils.cpp:1187-1256): 1-based node
    ids in creation order (contig then its _R twin), directed edges in
    (source, target) scan order. `graph` is the dict populated by
    merge_contigs(..., graph_out=...)."""
    def node_name(v):
        return f"{names[v // 2]}{'_R' if v & 1 else ''}"
    N = graph.get("n", 0)
    # byte-exact stream mirror, including the header-label quirk: the
    # quoted label ends in '\n"' with no trailing newline, so the first
    # 'node [' is glued onto the closing quote ('"node [')
    s = "graph [\n"
    s += 'comment "Automatically generated by Graphing tool"'
    s += "\ndirected  1\n"
    s += "id  1\n"
    s += 'label "To be more meaningful later....\n"'
    for v in range(N):
        s += ("node [\n" + f"id {v + 1}\n" + f'label "{node_name(v)}"\n'
              + "defaultAtrribute   1\n]\n")
    for (u, v) in sorted(graph.get("edges", {})):
        s += ("edge [\n" + f"source {u + 1}\n" + f"target  {v + 1}\n"
              + 'label ""\n]\n')
    return s + "\n]\n"


def merge_contigs_multi(contig_lists, cfg: MergeConfig,
                        graph_outs=None):
    """Batched merge over many gaps' contig lists.

    Per-gap semantics are identical to merge_contigs (same node order,
    candidate order, edge insertion order, path selection); batching
    only groups the device work: ONE overlap-screen dispatch and ONE
    exact-Evaluate dispatch (per shape bucket) cover every gap's
    surviving pairs, and path splicing runs level-synchronously — all
    paths' step-i relax evaluations share a dispatch: O(path length)
    device round trips instead of O(gaps * pairs).

    Returns a list of (merged, infos) per gap; graph_outs, if given,
    is a parallel list of dicts to fill like merge_contigs' graph_out.
    """
    G = len(contig_lists)
    results: list[tuple[list, list]] = [([], []) for _ in range(G)]
    nodes_of: list[list[np.ndarray]] = []
    all_pairs: list[tuple[int, int, int]] = []    # (gap, a, b)
    k = cfg.kmer_len
    WIN = 30
    for gi, contigs in enumerate(contig_lists):
        # node order INTERLEAVED like the reference (contig then its
        # twin: ContigsCompactor.cpp:794-799) — the set<Node*>
        # orderings that drive candidate picks and revcomp-path dedup
        # follow creation order, so parity requires the same
        # numbering. Twin of v = v ^ 1.
        nodes: list[np.ndarray] = []
        for c in contigs:
            nodes.append(np.asarray(c, np.int8))
            nodes.append(dna.revcomp(c))
        nodes_of.append(nodes)
        if graph_outs is not None:
            graph_outs[gi].update(n=len(nodes), edges={})
        if not contigs:
            continue
        N = len(nodes)
        # reference quick check (QuickCheckerContigsMatch, :1982-2096):
        # pair (i, j) is feasible when ANY k-mer of seq j's first or
        # last 30 bp occurs ANYWHERE in seq i. Pairs enumerated i <= j
        # in lexicographic order (runMultiThreadChecker); i == j always
        # ends in containment, so it is skipped here.
        whole = [set(_kmer_hashes(s, k).tolist()) for s in nodes]
        wins = []
        for s in nodes:
            w = set(_kmer_hashes(s[:WIN], k).tolist())
            w |= set(_kmer_hashes(s[-WIN:], k).tolist())
            wins.append(w)
        pairs = [(i, j) for i in range(N) for j in range(i + 1, N)
                 if wins[j] & whole[i]]
        if len(pairs) > cfg.max_candidates:
            log.warn_cap(
                "merge_candidates_truncated",
                "overlap-candidate screen kept %d of %d pairs "
                "(max_candidates); later pairs dropped — raise "
                "max_candidates for reference-exact behavior",
                cfg.max_candidates, len(pairs))
            pairs = pairs[:cfg.max_candidates]
        all_pairs += [(gi, a, b) for a, b in pairs]

    if not all_pairs:
        return results

    # device screen: batched overlap scores upper-bound the exact
    # evaluation; pairs that cannot reach the minimum significant
    # score skip the exact DP (the reference pays the full DP per pair)
    qs = [nodes_of[g][a] for g, a, _ in all_pairs]
    ts = [nodes_of[g][b] for g, _, b in all_pairs]
    s, _qe, _te = _sw_batch_np(qs, ts, "overlap", MERGE_PARAMS,
                               end_slack=cfg.max_clip_len)
    floor = int(np.ceil(cfg.min_overlap_len_scaffold *
                        (1.0 - cfg.frac_score_loss)))
    surv = [(g, a, b) for (g, a, b), sc in zip(all_pairs, s)
            if int(sc) >= floor]

    # one exact evaluation per unordered pair; the winning end decides
    # the direction (threadMergeContigV2, ContigsCompactor.cpp:623-693).
    # The device kernel evaluates every gap's surviving pairs together;
    # edges are inserted in original per-gap pair order (a parity-
    # bearing tie-break).
    evs = evaluate_pairs([(nodes_of[g][a], nodes_of[g][b])
                          for g, a, b in surv], cfg)
    edges_of: dict[int, dict] = {}
    adj_of: dict[int, dict] = {}
    truncated_out = 0
    for (g, a, b), r in zip(surv, evs):
        if r.code != OVERLAP_LARGER_MINLEN or r.is_containment:
            continue
        nodes = nodes_of[g]
        ovsz = r.overlap_size(len(nodes[a]), len(nodes[b]))
        if r.pos_row + r.nclip == len(nodes[a]):
            u, v = a, b                      # MODE_1_2: seq1 first
        else:
            u, v = b, a                      # MODE_2_1
        adj = adj_of.setdefault(g, {})
        lst = adj.setdefault(u, [])
        if cfg.max_out_edges and len(lst) >= cfg.max_out_edges:
            truncated_out += 1
            continue
        lst.append(v)
        edges_of.setdefault(g, {})[(u, v)] = (ovsz,)
    if truncated_out:
        log.warn_cap(
            "merge_out_edges_truncated",
            "merge graph dropped %d outgoing overlap edge(s) beyond "
            "max_out_edges=%d — set max_out_edges=0 for "
            "reference-exact behavior", truncated_out, cfg.max_out_edges)

    # per-gap path enumeration (host graph algorithms), then LEVEL-
    # SYNCHRONOUS splicing: FormMergedSeqFromPath
    # (ContigsCompactor.cpp:1456-1515) re-evaluates left-to-right in
    # relax mode; step i of every path (across all gaps) shares one
    # batched device evaluation.
    tasks: list[tuple[int, tuple[int, ...]]] = []    # (gap, path)
    for g, edges in edges_of.items():
        if graph_outs is not None:
            graph_outs[g].update(n=len(nodes_of[g]), edges=dict(edges))
        paths = enumerate_paths(len(nodes_of[g]), edges, cfg,
                                adj=adj_of[g])
        n_taken = 0
        for pi, path in enumerate(paths):
            if len(path) <= 1:
                continue                # reference emits len>1 only
            if n_taken >= cfg.max_paths_per_gap:
                log.warn_cap(
                    "merge_paths_truncated",
                    "max_paths_per_gap=%d reached; %d merged path(s) "
                    "dropped", cfg.max_paths_per_gap,
                    sum(1 for p in paths[pi:] if len(p) > 1))
                break
            tasks.append((g, path))
            n_taken += 1

    cur = [nodes_of[g][p[0]] for g, p in tasks]
    step_i = 1
    while True:
        idx = [t for t, (g, p) in enumerate(tasks) if len(p) > step_i]
        if not idx:
            break
        evs = evaluate_pairs(
            [(cur[t], nodes_of[tasks[t][0]][tasks[t][1][step_i]])
             for t in idx], cfg, relax=True)
        for t, r in zip(idx, evs):
            cur[t] = r.merged
        step_i += 1

    for (g, path), seq in zip(tasks, cur):
        merged, infos = results[g]
        merged.append(seq)
        infos.append(list(path))
    return results


def merge_contigs(contigs: list[np.ndarray], cfg: MergeConfig,
                  graph_out: dict | None = None):
    """Returns (merged list of np arrays, info list of node-index paths).

    Node space interleaved like the reference's creation order
    (ContigsCompactor.cpp:794-799): node 2i = contig i, node 2i+1 =
    its revcomp twin.

    graph_out: optional dict populated with the overlap digraph
    ({"n": node count, "edges": {(u, v): (overlap,)}}) for the GML
    dump (merge_graph_gml) and other diagnostics.
    """
    outs = [graph_out] if graph_out is not None else None
    return merge_contigs_multi([contigs], cfg, graph_outs=outs)[0]


def _tarjan_scc(N: int, adj: dict[int, list[int]]) -> list[list[int]]:
    """Iterative Tarjan; SCCs returned in TOPOLOGICAL order of the
    condensation (the reference reverses Tarjan's output,
    GraphUtils.cpp:1060-1065)."""
    index = {}
    low = {}
    on_stack = set()
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = [0]
    for root in range(N):
        if root in index:
            continue
        # explicit DFS stack: (node, iterator position)
        work = [(root, 0)]
        while work:
            u, pi = work[-1]
            if pi == 0:
                index[u] = low[u] = counter[0]
                counter[0] += 1
                stack.append(u)
                on_stack.add(u)
            nbrs = adj.get(u, ())
            advanced = False
            while pi < len(nbrs):
                v = nbrs[pi]
                pi += 1
                if v not in index:
                    work[-1] = (u, pi)
                    work.append((v, 0))
                    advanced = True
                    break
                if v in on_stack:
                    low[u] = min(low[u], index[v])
            if advanced:
                continue
            work.pop()
            if low[u] == index[u]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == u:
                        break
                sccs.append(sorted(comp))
            if work:
                p = work[-1][0]
                low[p] = min(low[p], low[u])
    sccs.reverse()
    return sccs


# default per-root path-count limit (MAX_CONTIG_IN_PATH_COUNT = 20,
# ContigsCompactor.cpp:34; overridden by MergeConfig.max_paths_per_root
# = the reference's -p2; the reference's loop emits max+1 paths — kept
# faithfully)
MAX_PATHS_PER_ROOT = 20


def enumerate_paths(N: int, edges: dict, cfg: MergeConfig, adj=None):
    """FindSimplePathsTopSort parity (GraphUtils.cpp:625-771).

    Returns deduped node-index paths, reference semantics:
    SCC-condensation rank (Tarjan emission reversed, neighbor walks in
    EDGE-INSERTION order); roots = nodes with no cross-SCC incoming
    edge / ends = none outgoing (multi-node SCCs keep at most one
    representative, :1299-1340); per root a min-weight DP over rank
    order with edge weight -overlap (back-edges by rank ignored,
    strict-improvement relaxation) gives one path per reachable end;
    per root the longest-by-node-count are kept up to the
    MAX_PATHS_PER_ROOT(+1) quirk — trivial single-node paths count
    toward that cap exactly as in the reference (its output stage
    then drops them, ContigsCompactor.cpp:954). Node twins are
    interleaved: twin(v) = v ^ 1.
    """
    if adj is None:
        adj = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)

    sccs = _tarjan_scc(N, adj)
    scc_of = {}
    rank = {}
    r = 0
    for ci, comp in enumerate(sccs):
        for v in comp:
            scc_of[v] = ci
            rank[v] = r
            r += 1
    order = sorted(range(N), key=lambda v: rank[v])

    def candidates(start: bool) -> list[int]:
        cand = set(range(N))
        for u in range(N):
            for v in adj.get(u, ()):
                if scc_of[u] != scc_of[v]:
                    cand.discard(v if start else u)
        # multi-node SCCs: keep one representative only if the whole
        # SCC survived, else none (GraphUtils.cpp:1299-1340)
        for comp in sccs:
            if len(comp) <= 1:
                continue
            all_in = all(v in cand for v in comp)
            keep = comp[0] if start else comp[-1]
            for v in comp:
                if v != keep or not all_in:
                    cand.discard(v)
        return sorted(cand, key=lambda v: rank[v])

    roots = candidates(True)
    ends = candidates(False)
    end_set = set(ends)

    INF = float("inf")
    all_paths: list[tuple[int, ...]] = []
    seen_paths: set[tuple[int, ...]] = set()
    for root in roots:
        dist = {v: INF for v in range(N)}
        path: dict[int, tuple[int, ...]] = {root: (root,)}
        dist[root] = 0.0
        for u in order:
            if rank[u] < rank[root] or dist[u] >= INF:
                continue
            for v in adj.get(u, ()):
                if rank[v] < rank[u]:
                    continue  # back-edge within/into an earlier SCC
                w = -float(edges[(u, v)][0])   # weight = -overlap
                if dist[u] + w < dist[v]:
                    dist[v] = dist[u] + w
                    path[v] = path[u] + (v,)
        found = [path[e] for e in ends if dist[e] < INF]
        found.sort(key=lambda p: (-len(p), p))
        for num_out, p in enumerate(found):
            if num_out > cfg.max_paths_per_root:
                break
            if p not in seen_paths:
                seen_paths.add(p)
                all_paths.append(p)

    # RemoveDupRevCompPaths (ContigsCompactor.cpp:1422-1454): drop a
    # path when its twin-reversed image is also present and ordered
    # strictly before it (set order = node creation order because the
    # numbering is interleaved)
    def rc_path(p):
        return tuple(v ^ 1 for v in reversed(p))

    ordered = sorted(all_paths)
    pos = {p: i for i, p in enumerate(ordered)}
    out = []
    for p in ordered:
        q = rc_path(p)
        if q in pos and pos[q] < pos[p]:
            continue
        out.append(p)
    return out
