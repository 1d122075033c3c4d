"""pick_full combo/selection logic vs a literal transcription of
run_pick_full_constructed_contig (pick_contigs.py:150-330).

Feeds identical synthetic hit tables to both; the chosen contig and
fill span must agree (modulo the documented deviations: deterministic
tie-breaks and the exact-span fix, which this oracle reproduces)."""

import numpy as np
import pytest

from gappadder import dna
from gappadder.pipeline import pick
from gappadder.pipeline.pick import (FlankHit, UNCLIP, LEFT_CLIP,
                                         RIGHT_CLIP, BOTH_CLIP)

COMBOS = [(UNCLIP, UNCLIP), (UNCLIP, LEFT_CLIP), (UNCLIP, RIGHT_CLIP),
          (LEFT_CLIP, UNCLIP), (LEFT_CLIP, RIGHT_CLIP),
          (RIGHT_CLIP, UNCLIP), (RIGHT_CLIP, LEFT_CLIP)]


def _oracle(hits, contig_lens):
    """Reference logic with deterministic tie-breaks (lowest contig
    index first-best) and exact spans (tend/tstart based)."""
    table = {}
    for h in hits:
        if h.clip_type == BOTH_CLIP:
            continue
        key = (h.contig, h.side, h.clip_type)
        if key not in table or h.match_len > table[key].match_len:
            table[key] = h
    picked = {}
    for c in sorted({c for (c, _, _) in table}):
        best = None
        for lct, rct in COMBOS:
            lh = table.get((c, "left", lct))
            rh = table.get((c, "right", rct))
            if lh is None or rh is None or lh.rc != rh.rc:
                continue
            tot = lh.match_len + rh.match_len
            if best is None or tot > best[0]:
                best = (tot, lh, rh)
        if best:
            picked[c] = best[1:]
    best_c, best_span = None, None
    for c in sorted(picked):
        lh, rh = picked[c]
        if lh.rc:
            s, e = rh.tend, lh.map_pos - 1
        else:
            s, e = lh.tend, rh.map_pos - 1
        if best_span is None or (e - s) > best_span:
            best_span, best_c = e - s, c
    if best_c is None:
        return None
    lh, rh = picked[best_c]
    if lh.rc:
        s, e = rh.tend, lh.map_pos - 1
    else:
        s, e = lh.tend, rh.map_pos - 1
    return best_c, max(s, 0), max(e, max(s, 0)), lh.rc


def _rand_hits(rng, n_contigs, clen):
    hits = []
    for c in range(n_contigs):
        for side in ("left", "right"):
            for _ in range(int(rng.integers(0, 3))):
                ct = int(rng.choice([UNCLIP, LEFT_CLIP, RIGHT_CLIP,
                                     BOTH_CLIP]))
                ml = int(rng.integers(20, 140))
                ts = int(rng.integers(0, max(clen - ml, 1)))
                hits.append(FlankHit(
                    contig=c, side=side, rc=bool(rng.integers(0, 2)),
                    score=ml, map_pos=ts + 1, match_len=ml,
                    clip_type=ct, qstart=0, qend=ml, tend=ts + ml))
    return hits


@pytest.mark.parametrize("seed", range(12))
def test_pick_full_matches_reference_logic(seed):
    rng = np.random.default_rng(seed)
    n_contigs = int(rng.integers(1, 5))
    clen = 400
    contigs = rng.integers(0, 4, (n_contigs, clen)).astype(np.int8)
    lens = np.full(n_contigs, clen, np.int32)
    hits = _rand_hits(rng, n_contigs, clen)

    want = _oracle(hits, lens)
    got = pick.pick_full(hits, contigs, lens)
    if want is None:
        assert got is None
        return
    assert got is not None
    wc, ws_, we, wrc = want
    gc, gseq, grc, _ = got
    assert gc == wc
    assert grc == wrc
    span = contigs[wc][ws_:we]
    if wrc:
        span = dna.revcomp(span)
    np.testing.assert_array_equal(gseq, span)


def _mk_contig_arrays(contig_str):
    codes = dna.encode(contig_str)
    C = np.full((1, len(codes)), dna.N, np.int8)
    C[0, :len(codes)] = codes
    return C[None], np.array([[len(codes)]], np.int32), np.array([1], np.int32)


def test_multi_hit_secondary_wins_combo(rng):
    """VERDICT r1 #4 adversarial case: the left flank's BEST local hit
    is a both-ends-clipped decoy copy (dropped by the combo rules); the
    TRUE placement is a weaker secondary hit. bwa `-a` reports both;
    single-hit enumeration misses the closure, multi-hit closes it."""
    b = np.array(list("ACGT"))
    FL = "".join(b[rng.integers(0, 4, 300)])   # left flank
    FR = "".join(b[rng.integers(0, 4, 300)])   # right flank
    fill = "".join(b[rng.integers(0, 4, 150)])
    # contig starts 100bp INTO the left flank -> true left hit is
    # LEFT_CLIP with match 200; decoy after FR: exact copy of
    # FL[5:295] -> local score 290 (> 200) but BOTH_CLIP
    contig = FL[100:] + fill + FR + "TT" + FL[5:295] + "GG"

    Cseq, Clen, Ccnt = _mk_contig_arrays(contig)
    flank_l = dna.encode(FL)[None]
    flank_r = dna.encode(FR)[None]

    # single-hit: decoy shadows the true hit -> no full closure
    hits1 = pick.align_flanks_to_contigs(
        flank_l, flank_r, Cseq, Clen, Ccnt, min_score=30, max_hits=1)
    left_types1 = {h.clip_type for h in hits1[0] if h.side == "left"}
    assert pick.LEFT_CLIP not in left_types1  # true hit invisible
    res1 = pick.pick_full(hits1[0], Cseq[0], Clen[0])

    # multi-hit: the secondary (true) hit surfaces and closes the gap
    hits3 = pick.align_flanks_to_contigs(
        flank_l, flank_r, Cseq, Clen, Ccnt, min_score=30, max_hits=3)
    left_types3 = {h.clip_type for h in hits3[0] if h.side == "left"}
    assert pick.LEFT_CLIP in left_types3
    res3 = pick.pick_full(hits3[0], Cseq[0], Clen[0])
    assert res3 is not None
    _c, gap_seq, rc, _ = res3
    assert not rc
    assert dna.decode(gap_seq) == fill
    # and the single-hit result was either missing or wrong
    assert res1 is None or dna.decode(res1[1]) != fill
