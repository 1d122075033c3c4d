"""K-mer extraction, packing, counting — the KMC replacement (L0).

The reference shells out to KMC (`kmc -k{k} -ci0`, assemble_gaps.py:96-102)
to count k-mers of each gap's read set, then assembles the DISTINCT
k-mers themselves with Velvet. Here k-mers are packed 2-bit multi-limb
integers in device arrays; counting distinct k-mers is a batched sort +
run-length pass (per gap, vmapped over a gap batch).

Packing: a k-mer is ceil(k/16) uint32 limbs, big-endian within and
across limbs (base 0 in the top bits of limb 0, unused tail bits zero),
so lexicographic order of limb tuples == lexicographic order of the
base string, and multi-operand `lax.sort` sorts k-mer sets correctly.

All functions are jit-friendly with static shapes; invalid slots
(containing N, out of range, padding) get all-ones limbs which sort
last and are excluded by the validity mask / count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

FULL = jnp.uint32(0xFFFFFFFF)


def num_limbs(k: int) -> int:
    return (k + 15) // 16


@functools.partial(jax.jit, static_argnames=("k",))
def extract_kmers(seq, length, k: int):
    """Rolling k-mer extraction from one padded sequence batch.

    Args:
      seq: int8/int32 [..., L] codes (0..3 valid, >=4 invalid).
      length: int32 [...] valid lengths.
      k: k-mer size (static, <= 64).

    Returns:
      limbs: uint32 [..., P, nl] with P = L-k+1 positions.
      valid: bool [..., P] — window inside `length` and free of N.
    """
    L = seq.shape[-1]
    P = L - k + 1
    assert P >= 1, "sequence shorter than k"
    nl = num_limbs(k)
    seq32 = seq.astype(jnp.uint32)
    isbad = (seq >= 4) | (seq < 0)

    limbs = []
    for l in range(nl):
        acc = jnp.zeros(seq.shape[:-1] + (P,), jnp.uint32)
        for j in range(16):
            pos = 16 * l + j
            if pos >= k:
                break
            chunk = jax.lax.slice_in_dim(seq32, pos, pos + P, axis=-1)
            acc = acc | (chunk << (30 - 2 * j))
        limbs.append(acc)
    limbs = jnp.stack(limbs, axis=-1)                     # [..., P, nl]

    # validity: no bad base in window, window fits in length
    badc = jnp.cumsum(isbad.astype(jnp.int32), axis=-1)
    bad0 = jnp.concatenate(
        [jnp.zeros(seq.shape[:-1] + (1,), jnp.int32), badc], axis=-1)
    win_bad = (jax.lax.slice_in_dim(bad0, k, k + P, axis=-1)
               - jax.lax.slice_in_dim(bad0, 0, P, axis=-1)) > 0
    pos_idx = jnp.arange(P, dtype=jnp.int32)
    inside = pos_idx <= (length[..., None].astype(jnp.int32) - k)
    valid = inside & ~win_bad
    limbs = jnp.where(valid[..., None], limbs, FULL)
    return limbs, valid


def _rev2bit(w):
    """Reverse the 16 2-bit groups of each uint32 (bitwise ladder:
    4 swap rounds instead of 16 unpack/repack steps)."""
    w = ((w & jnp.uint32(0x33333333)) << 2) | \
        ((w & jnp.uint32(0xCCCCCCCC)) >> 2)
    w = ((w & jnp.uint32(0x0F0F0F0F)) << 4) | \
        ((w & jnp.uint32(0xF0F0F0F0)) >> 4)
    w = ((w & jnp.uint32(0x00FF00FF)) << 8) | \
        ((w & jnp.uint32(0xFF00FF00)) >> 8)
    return (w << 16) | (w >> 16)


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp_kmers(limbs, k: int):
    """Reverse-complement packed k-mers (same limb layout).

    Complement of the 2-bit code is its bitwise NOT (A=00<->T=11,
    C=01<->G=10), so revcomp = NOT + 2-bit-group reversal (a 4-round
    swap ladder per limb) + a cross-limb realignment shift by the
    unused tail bits — ~10 VPU ops per limb instead of the old
    per-base unpack/repack (~4k ops)."""
    nl = num_limbs(k)
    # reverse limb order, reverse 2-bit groups within limbs, complement
    rev = [_rev2bit(~limbs[..., nl - 1 - l]) for l in range(nl)]
    # the k bases now sit right-aligned with 2*(16*nl - k) dead bits on
    # top; shift the whole multi-limb value LEFT by that amount
    sh = 2 * (16 * nl - k)
    if sh:
        out = []
        for l in range(nl):
            v = rev[l] << sh
            if l + 1 < nl:
                v = v | (rev[l + 1] >> (32 - sh))
            out.append(v)
    else:
        out = rev
    # zero the unused tail bits of the last limb (packing invariant)
    used = k - 16 * (nl - 1)
    tail_mask = jnp.uint32(((1 << (2 * used)) - 1) << (32 - 2 * used))
    out[nl - 1] = out[nl - 1] & tail_mask
    res = jnp.stack(out, axis=-1)
    # invalid slots stay invalid
    invalid = jnp.all(limbs == FULL, axis=-1, keepdims=True)
    return jnp.where(invalid, FULL, res)


@functools.partial(jax.jit, static_argnames=("k",))
def canonicalize(limbs, k: int):
    """Per-kmer min(kmer, revcomp) — KMC's canonical counting."""
    rc = revcomp_kmers(limbs, k)
    nl = limbs.shape[-1]
    lt = jnp.zeros(limbs.shape[:-1], bool)
    gt = jnp.zeros(limbs.shape[:-1], bool)
    for l in range(nl):
        a, b = limbs[..., l], rc[..., l]
        lt = lt | (~gt & (a < b))
        gt = gt | (~lt & (a > b))
    take_fwd = lt | ~gt
    return jnp.where(take_fwd[..., None], limbs, rc)


def sort_kmers(limbs, extra=None):
    """Sort a [..., P, nl] k-mer array lexicographically along P.

    extra: optional list of [..., P] arrays carried through the sort.
    Returns (sorted_limbs, sorted_extras).
    """
    nl = limbs.shape[-1]
    ops = [limbs[..., l] for l in range(nl)]
    extras = list(extra) if extra is not None else []
    res = jax.lax.sort(tuple(ops + extras), dimension=limbs.ndim - 2,
                       num_keys=nl)
    s = jnp.stack(res[:nl], axis=-1)
    return s, list(res[nl:])


def unique_mask(sorted_limbs):
    """True at the first slot of each distinct k-mer (valid or not)."""
    same = jnp.all(sorted_limbs == jnp.roll(sorted_limbs, 1, axis=-2), axis=-1)
    first = jnp.ones(sorted_limbs.shape[:-1], bool).at[..., 1:].set(
        ~same[..., 1:])
    return first


@functools.partial(jax.jit, static_argnames=("k",))
def count_distinct(seq, length, k: int):
    """KMC-equivalent: canonical k-mer counting over one batch of
    sequence sets.

    Args:
      seq: int8 [..., L]; length: [...] lengths.

    Returns:
      kmers: uint32 [..., P, nl] sorted distinct canonical k-mers,
        compacted to the front; invalid/duplicate slots = FULL.
      counts: int32 [..., P] multiplicity of each distinct k-mer
        (0 on non-first slots).
      n_distinct: int32 [...].
    """
    limbs, valid = extract_kmers(seq, length, k)
    limbs = canonicalize(limbs, k)
    limbs = jnp.where(valid[..., None], limbs, FULL)
    s, _ = sort_kmers(limbs)
    first = unique_mask(s)
    sval = ~jnp.all(s == FULL, axis=-1)
    firstv = first & sval
    # counts by run length: positions of firsts
    P = s.shape[-2]
    idx = jnp.arange(P, dtype=jnp.int32)
    # for each slot, index of its run start
    run_start = jax.lax.cummax(jnp.where(firstv, idx, -1), axis=s.ndim - 2)
    # count = number of slots with same run start
    ones = sval.astype(jnp.int32)
    # segment count via sorted segment ids (run_start monotone)
    csum = jnp.cumsum(ones, axis=-1)
    zero = jnp.zeros_like(csum[..., :1])
    c0 = jnp.concatenate([zero, csum], axis=-1)
    # count for run starting at i = csum[end] - csum[i] where end is next
    # run start; easier: counts[i] = (# valid) in run = gather trick below.
    nxt = _next_first(firstv)
    counts = jnp.take_along_axis(c0, nxt, axis=-1) - \
        jnp.take_along_axis(c0, jnp.where(firstv, idx, 0), axis=-1)
    counts = jnp.where(firstv, counts, 0)
    n_distinct = jnp.sum(firstv, axis=-1).astype(jnp.int32)
    # compact distinct kmers to front
    order = jnp.argsort(~firstv, axis=-1, stable=True)
    kmers = jnp.take_along_axis(s, order[..., None], axis=-2)
    counts = jnp.take_along_axis(counts, order, axis=-1)
    kmers = jnp.where((jnp.arange(P) < n_distinct[..., None])[..., None],
                      kmers, FULL)
    return kmers, counts, n_distinct


def _next_first(firstv):
    """For each slot i, the index of the next run-start after i (or P)."""
    P = firstv.shape[-1]
    idx = jnp.arange(P, dtype=jnp.int32)
    # suffix-min of (firstv ? idx : P) = next run-start at or after i
    sufmin = jnp.flip(jax.lax.cummin(jnp.flip(
        jnp.where(firstv, idx, P), axis=-1), axis=firstv.ndim - 1), axis=-1)
    nxt = jnp.concatenate([sufmin[..., 1:],
                           jnp.full_like(sufmin[..., :1], P)], axis=-1)
    return nxt
