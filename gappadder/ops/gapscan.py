"""Vectorized N-run (gap) detection and flank extraction.

Vectorized replacement for the reference's per-scaffold string-scan
loop (``DGProcessor.gnrt_gap_positions``,
/root/reference/gnrt_pos_true_seqs.py:12-56) and flank slicing
(``get_gap_flank_seqs``, :59-100).

Semantics matched to the reference:
  * a gap is a maximal run of non-ACGT codes (the reference starts at
    'N' and ends at the next A/C/G/T, so interior non-N ambiguity codes
    are swallowed into the gap);
  * a run with no ACGT after it in the same scaffold (trailing Ns) is
    dropped (reference: ``min_pos==-1 -> break``);
  * runs shorter than ``min_gap_size`` are dropped;
  * gap ids are "<scaffold_idx>_<n>" with n starting at 1 per scaffold;
  * left flank  = scaffold[max(0, start-flank_len) : start-margin]
    right flank = scaffold[end+margin : end+flank_len]  (margin=5).

Everything is fixed-shape: the scan is jittable with a static
``max_gaps`` bound and shards cleanly along the genome axis (the mask
/ cumsum ops are embarrassingly parallel; XLA partitions them).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna


@functools.partial(jax.jit, static_argnames=("min_gap_size", "max_gaps"))
def find_gap_runs(seq, min_gap_size: int, max_gaps: int):
    """Locate qualifying N-runs in a concatenated genome code array.

    Args:
      seq: int8 [L] codes (SEP between scaffolds).
      min_gap_size: minimum run length to report.
      max_gaps: static bound on the number of returned runs.

    Returns:
      starts, ends: int32 [max_gaps] global coordinates (end exclusive),
        padded with -1 beyond the valid count.
      count: int32 scalar, number of valid runs.
    """
    is_gap = seq == dna.N
    prev = jnp.concatenate([jnp.zeros(1, bool), is_gap[:-1]])
    nxt = jnp.concatenate([is_gap[1:], jnp.zeros(1, bool)])
    start_mask = is_gap & ~prev
    end_mask = is_gap & ~nxt

    # trailing-run detection: a run qualifies only if some ACGT follows
    # before the next SEP. Scan right-to-left: for each position, does an
    # ACGT appear later in the same scaffold?
    is_acgt = seq < dna.N
    is_sep = seq == dna.SEP
    # segment id increases at each SEP; suffix-max of is_acgt within segment:
    # reverse, segment-wise cumulative-or via cummax on int.
    rev_acgt = is_acgt[::-1].astype(jnp.int32)
    rev_sep = is_sep[::-1]
    seg = jnp.cumsum(rev_sep.astype(jnp.int32))
    # cummax of rev_acgt keyed by segment: encode (seg, flag) so resets work
    enc = seg * 2 + rev_acgt
    run = jax.lax.cummax(enc)
    acgt_follows = (run - seg * 2)[::-1] > 0  # flag survives within segment

    starts_all = jnp.nonzero(start_mask, size=max_gaps, fill_value=-1)[0]
    ends_all = jnp.nonzero(end_mask, size=max_gaps, fill_value=-1)[0]
    valid = starts_all >= 0
    ends_excl = jnp.where(valid, ends_all + 1, -1)
    length = jnp.where(valid, ends_excl - starts_all, 0)
    keep = valid & (length >= min_gap_size) & acgt_follows[jnp.clip(starts_all, 0, seq.shape[0] - 1)]

    # compact kept runs to the front, preserving order
    order = jnp.argsort(~keep, stable=True)
    starts = jnp.where(keep[order], starts_all[order], -1).astype(jnp.int32)
    ends = jnp.where(keep[order], ends_excl[order], -1).astype(jnp.int32)
    count = jnp.sum(keep).astype(jnp.int32)
    return starts, ends, count


@functools.partial(jax.jit, static_argnames=("flank_len", "margin"))
def extract_flanks(seq, starts, ends, scaf_begin, scaf_end,
                   flank_len: int, margin: int = 5):
    """Gather fixed-width left/right flanks for a batch of gaps.

    Args:
      seq: int8 [L] concatenated genome.
      starts, ends: int32 [G] global gap coords (end exclusive); -1 pads.
      scaf_begin, scaf_end: int32 [G] global bounds of each gap's scaffold.
      flank_len: window width (reference ``flank_length``).
      margin: bases dropped next to the gap (reference hard-codes 5).

    Returns:
      left, right: int8 [G, flank_len] codes, both LEFT-aligned in the
        array and N-padded after their length; left[g, :left_len[g]]
        ends at start-margin, right[g, :right_len[g]] begins at
        end+margin.
      left_len, right_len: int32 [G].
    """
    G = starts.shape[0]
    pad = starts < 0

    l_end = jnp.maximum(starts - margin, scaf_begin)           # exclusive
    l_begin = jnp.maximum(starts - flank_len, scaf_begin)
    left_len = jnp.where(pad, 0, jnp.maximum(l_end - l_begin, 0))

    r_begin = jnp.minimum(ends + margin, scaf_end)
    r_end = jnp.minimum(ends + flank_len, scaf_end)            # exclusive
    right_len = jnp.where(pad, 0, jnp.maximum(r_end - r_begin, 0))

    offs = jnp.arange(flank_len, dtype=jnp.int32)
    # left flank, left-aligned: position j holds seq[l_end - left_len + j]
    l_idx = l_end[:, None] - left_len[:, None] + offs[None, :]
    l_ok = offs[None, :] < left_len[:, None]
    left = jnp.where(l_ok, seq[jnp.clip(l_idx, 0, seq.shape[0] - 1)], dna.N)

    r_idx = r_begin[:, None] + offs[None, :]
    r_ok = offs[None, :] < right_len[:, None]
    right = jnp.where(r_ok, seq[jnp.clip(r_idx, 0, seq.shape[0] - 1)], dna.N)
    return (left.astype(jnp.int8), right.astype(jnp.int8),
            left_len.astype(jnp.int32), right_len.astype(jnp.int32))


def find_gap_runs_host(seq: np.ndarray, min_gap_size: int):
    """Host (numpy) twin of find_gap_runs: same semantics, no device
    round trip. The scan is O(L) elementwise work — for drafts below
    HOST_SCAN_MAX the host-device transfer costs more than the whole
    computation, so the pipeline uses this path there (tested equal to
    the jit kernel). Returns (starts, ends) int64 arrays of kept runs
    in order."""
    is_gap = seq == dna.N
    d = is_gap[1:] != is_gap[:-1]
    edges = np.flatnonzero(d) + 1
    if not len(edges) and not (len(seq) and is_gap[0]):
        z = np.zeros(0, np.int64)
        return z, z
    starts = edges[1::2] if is_gap[0] else edges[0::2]
    ends = edges[0::2] if is_gap[0] else edges[1::2]
    if is_gap[0]:
        starts = np.concatenate([[0], starts])
    if is_gap[-1]:
        ends = np.concatenate([ends, [len(seq)]])
    # trailing-run rule: an ACGT must follow within the same scaffold.
    # The char AFTER a run is never N (the run is maximal) and codes
    # are only {ACGT, N, SEP}, so "ACGT follows within the scaffold"
    # reduces to seq[ends] being ACGT — no full-genome segment
    # accumulates needed (they were ~80% of a 90 MB draft's preprocess)
    in_bounds = ends < len(seq)
    nxt = seq[np.minimum(ends, len(seq) - 1)]
    keep = (ends - starts >= min_gap_size) & in_bounds & (nxt < dna.N)
    return starts[keep].astype(np.int64), ends[keep].astype(np.int64)


# below this many bases the host scan is used (transfer + dispatch
# latency dwarf the O(L) elementwise work); above it the device
# kernels amortize and shard
HOST_SCAN_MAX = 1 << 28


def length_bucket(n: int) -> int:
    """Pad a length up to {1, 1.5} * 2^k — coarse enough that drafts of
    similar size share compiled shapes (compiles are the cold-run
    cost), fine enough to bound padding waste at 33%."""
    if n <= 1024:
        return 1024
    p = 1 << (n - 1).bit_length()
    return (p * 3) // 4 if n <= (p * 3) // 4 else p


def extract_flanks_host(seq, starts, ends, scaf_begin, scaf_end,
                        flank_len: int, margin: int = 5):
    """Host (numpy) twin of extract_flanks (same semantics/outputs)."""
    seq = np.asarray(seq)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    scaf_begin = np.asarray(scaf_begin, np.int64)
    scaf_end = np.asarray(scaf_end, np.int64)
    pad = starts < 0

    l_end = np.maximum(starts - margin, scaf_begin)
    l_begin = np.maximum(starts - flank_len, scaf_begin)
    left_len = np.where(pad, 0, np.maximum(l_end - l_begin, 0))
    r_begin = np.minimum(ends + margin, scaf_end)
    r_end = np.minimum(ends + flank_len, scaf_end)
    right_len = np.where(pad, 0, np.maximum(r_end - r_begin, 0))

    offs = np.arange(flank_len, dtype=np.int64)
    l_idx = l_end[:, None] - left_len[:, None] + offs[None, :]
    l_ok = offs[None, :] < left_len[:, None]
    left = np.where(l_ok, seq[np.clip(l_idx, 0, max(len(seq) - 1, 0))],
                    dna.N)
    r_idx = r_begin[:, None] + offs[None, :]
    r_ok = offs[None, :] < right_len[:, None]
    right = np.where(r_ok, seq[np.clip(r_idx, 0, max(len(seq) - 1, 0))],
                     dna.N)
    return (left.astype(np.int8), right.astype(np.int8),
            left_len.astype(np.int32), right_len.astype(np.int32))


def scan_genome_np(genome, min_gap_size: int, max_gaps: int | None = None):
    """Host convenience wrapper: run the jitted scan on a Genome and
    return a dict of numpy columns with per-scaffold gap numbering."""
    seq = genome.seq
    if seq.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return {"start": z, "end": z, "scaffold": z, "number": z,
                "local_start": z, "local_end": z}
    if seq.shape[0] <= HOST_SCAN_MAX:
        starts, ends = find_gap_runs_host(np.asarray(seq), min_gap_size)
        if max_gaps is not None:         # same contract as device path
            starts, ends = starts[:max_gaps], ends[:max_gaps]
        n = len(starts)
    else:
        if max_gaps is None:
            # exact bound: number of N-run starts (nonzero slots are
            # consumed by ALL runs, including sub-min_gap_size ones);
            # rounded to the next power of two so different drafts
            # share compiled shapes
            is_gap = seq == dna.N
            starts_mask = is_gap.copy()
            starts_mask[1:] &= ~is_gap[:-1]
            n_runs = max(16, int(starts_mask.sum()))
            max_gaps = 1 << (n_runs - 1).bit_length()
        # SEP-pad the genome axis to a shared shape bucket (SEP opens a
        # new empty scaffold segment: no run can span or qualify in it)
        Lb = length_bucket(seq.shape[0])
        if Lb != seq.shape[0]:
            seq = np.concatenate([seq, np.full(Lb - seq.shape[0],
                                               dna.SEP, np.int8)])
        starts, ends, count = find_gap_runs(jnp.asarray(seq),
                                            min_gap_size, max_gaps)
        n = int(count)
        starts = np.asarray(starts)[:n]
        ends = np.asarray(ends)[:n]
    scaf = genome.scaffold_index(starts)
    # per-scaffold counter starting at 1 (reference gap-id contract)
    counter = np.zeros(n, dtype=np.int64)
    seen: dict[int, int] = {}
    for i, s in enumerate(scaf):
        seen[s] = seen.get(s, 0) + 1
        counter[i] = seen[s]
    return {
        "start": starts.astype(np.int64),
        "end": ends.astype(np.int64),
        "scaffold": scaf.astype(np.int64),
        "number": counter,
        "local_start": starts - genome.offsets[scaf],
        "local_end": ends - genome.offsets[scaf],
    }
