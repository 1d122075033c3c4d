"""Pick stage: select the contig(s) anchored by the gap flanks.

Replaces the reference's bwa-mem-based contig selection
(pick_contigs.py): both flanks are aligned against every contig of a
gap (forward and reverse-complement queries) with the batched device
SW kernel using bwa-equivalent scoring; the handful of winning pairs
get a host traceback for clip typing; then the reference's selection
logic runs:

  FULL closure (run_pick_full_constructed_contig, pick_contigs.py:97-358):
    contigs hit by BOTH flanks on the same strand; 7 clip-type combos
    (no LEFT+LEFT / RIGHT+RIGHT / any BOTH_CLIP) scored by total
    aligned columns; the winning contig maximizes the inter-flank span;
    the spanned substring (revcomp'd if the flanks hit the reverse
    strand) is the gap fill, named "<gap_id>_<contig>".

  EXTENSION fallback (run_pick_extended_contig, :361-539): one-sided
    flank hits clipped toward the gap produce "left + NN + right"
    partial fills named "<gap_id>_<l>_<r>_extended".

Multi-hit enumeration (bwa `-a` parity, pick_contigs.py:80-86): up to
``max_hits`` NON-OVERLAPPING local alignments are enumerated per
(flank, contig, strand) by mask-and-rerun — after each SW pass, the
aligned target span of every reported hit is masked to N and the batch
realigned, so secondary repeat hits reach the combo scoring exactly as
bwa -a's hit list does. (Hits overlapping a better hit's target span
are not re-reported — bwa's own secondary-suppression behaves the
same way for contained repeats.)

Deviations from the reference (documented deliberately):
  * strand comes from which query orientation scored best — the
    reference's `flag*16 != 0` bug (pick_contigs.py:386, a typo for
    `flag & 16` that misclassifies secondary hits) is fixed;
  * dict-iteration tie-breaks are replaced by deterministic
    first-best-by-contig-index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import dna
from ..ops import sw_host
from ..ops.sw_host import BWA_PARAMS

UNCLIP, LEFT_CLIP, RIGHT_CLIP, BOTH_CLIP = 4, 2, 3, 1  # reference codes


@dataclasses.dataclass
class FlankHit:
    """One (flank, contig, strand) best local alignment."""
    contig: int
    side: str            # 'left' | 'right' flank
    rc: bool             # query was revcomp(flank)
    score: int
    map_pos: int         # 1-based target start (reference convention)
    match_len: int       # aligned columns (M-sum)
    clip_type: int
    qstart: int
    qend: int
    tend: int


from ..ops.swutil import sw_pairs


def align_flanks_to_contigs(flank_left, flank_right, contigs, contig_lens,
                            n_contigs, min_score: int,
                            max_hits: int = 3):
    """Align both flanks (fwd+rc) of each gap to each of its contigs.

    Args:
      flank_left/right: int8 [G, FL] padded codes (+ trailing N).
      contigs: int8 [G, C, Lmax]; contig_lens [G, C]; n_contigs [G].
      min_score: bwa -T equivalent on the SW score.
      max_hits: non-overlapping local hits enumerated per
        (flank, contig, strand) — the bwa `-a` multi-hit list
        (pick_contigs.py:80-86); 1 restores round-1 single-hit behavior.

    Returns: per gap, list[FlankHit] with score >= min_score.
    """
    G, FL = flank_left.shape
    C = contigs.shape[1]
    Lmax = contigs.shape[2]

    flank_len_l = (np.asarray(flank_left) != dna.N).sum(axis=1).astype(np.int32)
    flank_len_r = (np.asarray(flank_right) != dna.N).sum(axis=1).astype(np.int32)
    # queries: [G, 4, FL] = left fwd, left rc, right fwd, right rc
    fl = np.asarray(flank_left)
    fr = np.asarray(flank_right)
    q_arr = np.full((G, 4, FL), dna.N, np.int8)
    qlens = np.zeros((G, 4), np.int32)
    for g in range(G):
        ll, rl = int(flank_len_l[g]), int(flank_len_r[g])
        q_arr[g, 0, :ll] = fl[g, :ll]
        q_arr[g, 1, :ll] = dna.revcomp(fl[g, :ll])
        q_arr[g, 2, :rl] = fr[g, :rl]
        q_arr[g, 3, :rl] = dna.revcomp(fr[g, :rl])
        qlens[g] = (ll, ll, rl, rl)

    # pair batch: (g, qi, c) for c < n_contigs[g] with nonzero lens
    pg, pq, pc = [], [], []
    for g in range(G):
        for qi in range(4):
            if qlens[g, qi] == 0:
                continue
            for c in range(int(n_contigs[g])):
                if contig_lens[g, c] > 0:
                    pg.append(g); pq.append(qi); pc.append(c)
    if not pg:
        return [[] for _ in range(G)]
    pg = np.asarray(pg); pq = np.asarray(pq); pc = np.asarray(pc)
    q_batch = q_arr[pg, pq]
    ql_batch = qlens[pg, pq]
    t_batch = np.asarray(contigs)[pg, pc]
    tl_batch = np.asarray(contig_lens)[pg, pc]

    hits: list[list[FlankHit]] = [[] for _ in range(G)]

    # multi-hit local passes: mask each reported hit's target span to N
    # and realign, so secondary (repeat) placements surface like bwa -a
    t_work = np.array(t_batch, copy=True)
    first_score = None
    for _pass in range(max(max_hits, 1)):
        score, qend, tend = sw_pairs(
            q_batch, ql_batch, t_work, tl_batch, BWA_PARAMS, "local")
        if first_score is None:
            first_score = score
        score = np.asarray(score)
        qend = np.asarray(qend)
        tend = np.asarray(tend)
        win = np.nonzero(score >= min_score)[0]
        if len(win) == 0:
            break
        # batched host traceback for all winners of this pass (one
        # anti-diagonal sweep for the whole batch, not one per hit)
        qs_b, ts_b, ms_b = sw_host.alignment_stats_batch(
            q_batch[win], ql_batch[win], t_work[win], tl_batch[win],
            BWA_PARAMS, "local", qend[win], tend[win])
        for w, i in enumerate(win):
            g, qi, c = int(pg[i]), int(pq[i]), int(pc[i])
            qlen = int(ql_batch[i])
            side = "left" if qi < 2 else "right"
            rc = bool(qi % 2)
            qstart, tstart, m_sum = int(qs_b[w]), int(ts_b[w]), int(ms_b[w])
            lcl = qstart > 0
            rcl = int(qend[i]) < qlen
            if lcl and rcl:
                ct = BOTH_CLIP
            elif lcl:
                ct = LEFT_CLIP
            elif rcl:
                ct = RIGHT_CLIP
            else:
                ct = UNCLIP
            hits[g].append(FlankHit(
                contig=c, side=side, rc=rc, score=int(score[i]),
                map_pos=tstart + 1, match_len=m_sum, clip_type=ct,
                qstart=qstart, qend=int(qend[i]), tend=int(tend[i])))
            t_work[i, tstart:int(tend[i])] = dna.N

    # query-global ("fit") pass: supplies the UNCLIP candidates bwa -a
    # reports even when the best LOCAL hit trims a flank end
    # (reference combos need UNCLIP entries, pick_contigs.py:171-282).
    # bwa only emits an unclipped alignment when extending to the query
    # ends costs no more than its end-clip penalty (pen_clip5/3 = 5 per
    # end) — gate on that, or forced fits over clipped repeat decoys
    # would fabricate UNCLIP hits bwa never reports.
    END_BONUS = 5
    fscore, fqend, ftend = sw_pairs(
        q_batch, ql_batch, t_batch, tl_batch, BWA_PARAMS, "fit")
    score = np.asarray(first_score)
    fscore = np.asarray(fscore)
    fqend = np.asarray(fqend)
    ftend = np.asarray(ftend)
    fwin = np.nonzero((fscore >= min_score) & (fscore != score) &
                      (fscore >= score - 2 * END_BONUS))[0]
    if len(fwin):
        qs_b, ts_b, ms_b = sw_host.alignment_stats_batch(
            q_batch[fwin], ql_batch[fwin], t_batch[fwin], tl_batch[fwin],
            BWA_PARAMS, "fit", fqend[fwin], ftend[fwin])
        for w, i in enumerate(fwin):
            g, qi, c = int(pg[i]), int(pq[i]), int(pc[i])
            qlen = int(ql_batch[i])
            side = "left" if qi < 2 else "right"
            rc = bool(qi % 2)
            hits[g].append(FlankHit(
                contig=c, side=side, rc=rc, score=int(fscore[i]),
                map_pos=int(ts_b[w]) + 1, match_len=int(ms_b[w]),
                clip_type=UNCLIP, qstart=0, qend=qlen,
                tend=int(ftend[i])))
    return hits


# the 7 clip-type combos the reference scores (pick_contigs.py:171-282)
_COMBOS = [(UNCLIP, UNCLIP), (UNCLIP, LEFT_CLIP), (UNCLIP, RIGHT_CLIP),
           (LEFT_CLIP, UNCLIP), (LEFT_CLIP, RIGHT_CLIP),
           (RIGHT_CLIP, UNCLIP), (RIGHT_CLIP, LEFT_CLIP)]


def pick_full(gap_hits: list[FlankHit], contigs_g, contig_lens_g):
    """Full-closure selection for one gap.

    Returns (contig_idx, gap_seq_codes, rc, contig_codes) or None.
    """
    # per (contig, side, clip_type): best by match_len (reference keeps
    # max match_length per clip type, pick_contigs.py:125-130)
    table: dict[tuple[int, str, int], FlankHit] = {}
    for h in gap_hits:
        if h.clip_type == BOTH_CLIP:
            continue
        key = (h.contig, h.side, h.clip_type)
        if key not in table or h.match_len > table[key].match_len:
            table[key] = h

    picked: dict[int, tuple] = {}
    contigs_seen = sorted({c for (c, _, _) in table})
    for c in contigs_seen:
        best = None
        for lct, rct in _COMBOS:
            lh = table.get((c, "left", lct))
            rh = table.get((c, "right", rct))
            if lh is None or rh is None or lh.rc != rh.rc:
                continue
            total = lh.match_len + rh.match_len
            if best is None or total > best[0]:
                best = (total, lh, rh)
        if best is not None:
            picked[c] = (best[1], best[2])

    # fill span in 0-based contig coords, from the exact traceback
    # target coordinates (the reference's map_pos+match_len arithmetic
    # is equivalent for indel-free alignments but also includes the
    # right flank's first matched base, which its patcher then
    # re-drops — pick_contigs.py:347-349 + put_gap_seq_back:90; we
    # emit exactly the inter-flank span instead).
    def span(lh, rh):
        if lh.rc:
            return rh.tend, lh.map_pos - 1       # [tend_r, tstart_l)
        return lh.tend, rh.map_pos - 1           # [tend_l, tstart_r)

    s_picked, best_span = None, None
    for c in sorted(picked):
        lh, rh = picked[c]
        start, end = span(lh, rh)
        if best_span is None or (end - start) > best_span:
            best_span = end - start
            s_picked = c
    if s_picked is None:
        return None
    lh, rh = picked[s_picked]
    clen = int(contig_lens_g[s_picked])
    contig = np.asarray(contigs_g[s_picked][:clen])
    start, end = span(lh, rh)
    start = max(start, 0)
    end = max(end, start)
    if lh.rc:
        gap_seq = dna.revcomp(contig[start:end])
        contig_out = dna.revcomp(contig)
    else:
        gap_seq = contig[start:end]
        contig_out = contig
    return s_picked, gap_seq, lh.rc, contig_out


def pick_extension(gap_hits: list[FlankHit], contigs_g, contig_lens_g):
    """Extension fallback for one gap (pick_contigs.py:361-539).

    Returns (left_name_idx, right_name_idx, seq_codes, contig_codes)
    or None; name idx -1 when that side had no pick.
    """
    # keep only one-side-clipped hits clipped TOWARD the gap
    best_side: dict[tuple[str, int], FlankHit] = {}
    for h in gap_hits:
        if h.clip_type in (UNCLIP, BOTH_CLIP):
            continue
        if h.side == "left":
            # left flank: keep fwd+LEFT_CLIP / rc+RIGHT_CLIP is skipped:
            # reference skips (rc & LEFT) and (fwd & RIGHT)
            if (h.rc and h.clip_type == LEFT_CLIP) or \
               (not h.rc and h.clip_type == RIGHT_CLIP):
                continue
        else:
            if (h.rc and h.clip_type == RIGHT_CLIP) or \
               (not h.rc and h.clip_type == LEFT_CLIP):
                continue
        key = (h.side, h.contig)
        if key not in best_side or h.match_len > best_side[key].match_len:
            best_side[key] = h

    def pick_side(side):
        best = None
        for (s, c) in sorted(best_side):
            if s != side:
                continue
            h = best_side[(s, c)]
            if best is None or h.match_len > best.match_len:
                best = h
        return best

    lh = pick_side("left")
    rh = pick_side("right")
    if lh is None and rh is None:
        return None

    def contig_seq(c):
        return np.asarray(contigs_g[c][:int(contig_lens_g[c])])

    left_seq = np.zeros(0, np.int8)
    right_seq = np.zeros(0, np.int8)
    rc_l, rc_r = True, True
    contig_out = np.zeros(0, np.int8)

    if lh is not None and rh is not None and lh.contig == rh.contig:
        # same contig both sides: keep the longer-matching side
        if lh.match_len > rh.match_len:
            rh = None
        else:
            lh = None

    if lh is not None:
        s = contig_seq(lh.contig)
        rc_l = lh.rc
        if lh.rc:
            left_seq = s[:lh.map_pos]
        else:
            left_seq = s[lh.map_pos + lh.match_len - 1:]
        contig_out = s
    if rh is not None:
        s = contig_seq(rh.contig)
        rc_r = rh.rc
        if not rh.rc:
            right_seq = s[:max(rh.map_pos - 1, 0)]
        else:
            right_seq = s[rh.map_pos + rh.match_len - 1:]
        contig_out = np.concatenate(
            [contig_out, dna.encode("NN"), s]) if contig_out.size else s

    if rc_l:
        left_seq = dna.revcomp(left_seq)
    if rc_r:
        right_seq = dna.revcomp(right_seq)
    seq = np.concatenate([left_seq, dna.encode("NN"), right_seq])
    if len(seq) == 2:  # just "NN"
        return None
    return (lh.contig if lh else -1, rh.contig if rh else -1, seq,
            contig_out)
