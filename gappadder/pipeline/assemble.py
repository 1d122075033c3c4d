"""Assembly stage: per-gap multi-k de-Bruijn assembly (round 1 core).

Replaces the reference's per-gap KMC -> kmc_dump -> cvtFaToFq ->
velveth/velvetg subprocess chain (assemble_gaps.py:82-135): for each
(k, sub_k) setting, count each gap's distinct canonical k-mers on
device and assemble THE K-MERS THEMSELVES (the reference's trick that
bounds assembly input size) with the batched DBG unitig assembler.

Contigs from all settings are concatenated per gap with the
reference's "<k>_<sub_k>_" name prefixes (assemble_gaps.py:124-135).
Gap batches are padded/bucketed so shapes stay static across jit
calls.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna
from ..config import Config
from ..ops import dbg, kmers
from ..utils import log

FULL = 0xFFFFFFFF


@dataclasses.dataclass
class GapContigs:
    """Per-gap contig sets (padded arrays + names)."""
    seq: np.ndarray      # int8 [G, C, Lmax]
    length: np.ndarray   # int32 [G, C]
    count: np.ndarray    # int32 [G]
    names: list[list[str]]  # [G][C] contig names ("<k>_<sub_k>_<i>")


def gap_distinct_kmers(reads, read_len, n_reads, k: int,
                       max_distinct: int, read_chunk: int = 512,
                       min_count: int = 0):
    """Distinct canonical k-mers of each gap's read set, with counts.

    Args:
      reads: int8 [G, R, L] padded read codes.
      read_len: int32 [G, R].
      n_reads: int32 [G] valid rows.
      max_distinct: static bound M on distinct k-mers per gap (overflow
        drops the lexicographically largest k-mers).
      min_count: 0 keeps everything (the reference's `kmc -ci0`,
        assemble_gaps.py:96-102); -1 = adaptive: when a gap's median
        k-mer multiplicity is >= 4, singleton k-mers (mostly sequencing
        errors) are dropped — a coverage-aware error filter standing in
        for Velvet's tour-bus.

    Returns:
      kstrings: int8 [G, M, k]; n_kstrings: int32 [G];
      kcounts: int32 [G, M] multiplicity of each k-string in the reads
        (bubble-pop coverage for the DBG).
    """
    G, R, L = reads.shape
    if L < k:
        pad = np.full((G, R, k - L), dna.N, np.int8)
        reads = np.concatenate([np.asarray(reads), pad], axis=2)
        L = k
    acc = jnp.full((G, max_distinct, kmers.num_limbs(k)), FULL, jnp.uint32)
    cnt = jnp.zeros((G, max_distinct), jnp.int32)
    row_idx = jnp.arange(R)
    reads_j = jnp.asarray(reads)
    rlen_j = jnp.asarray(read_len, jnp.int32)
    nr_j = jnp.asarray(n_reads, jnp.int32)
    for lo in range(0, R, read_chunk):
        hi = min(lo + read_chunk, R)
        chunk = reads_j[:, lo:hi]
        clen = jnp.where((row_idx[lo:hi][None, :] < nr_j[:, None]),
                         rlen_j[:, lo:hi], 0)
        acc, cnt = _merge_chunk(chunk, clen, acc, cnt, k)

    acc, cnt, distinct = filter_min_count(acc, cnt, min_count)

    n = jnp.sum(distinct, axis=-1).astype(jnp.int32)
    kstr = dbg.unpack_kmers_to_strings(acc, k)
    n_np = np.asarray(n)
    # capacity saturated => lexicographically-largest k-mers may have
    # been dropped by the merge; caller must grow and retry (or warn)
    saturated = n_np >= max_distinct
    return np.asarray(kstr), n_np, np.asarray(cnt), saturated


def filter_min_count(acc, cnt, min_count: int):
    """Apply the min_kmer_count policy to a merged distinct-k-mer table
    (pure jit; shared by this stage and the fused slice).

    0 keeps everything (`kmc -ci0`, assemble_gaps.py:96-102); -1 is
    the adaptive error filter; >1 a fixed cutoff. Returns
    (acc, cnt, distinct) with survivors re-compacted to the front."""
    distinct = ~jnp.all(acc == jnp.uint32(FULL), axis=-1)
    if min_count == -1:
        counts = jnp.where(distinct, cnt, 0)
        # instance-weighted mean multiplicity (the average coverage of a
        # random k-mer OCCURRENCE): error singletons can dominate the
        # plain median, but contribute almost nothing here
        cf = counts.astype(jnp.float32)
        inst = jnp.sum(cf, axis=-1)
        inst2 = jnp.sum(cf * cf, axis=-1)
        mean_inst = inst2 / jnp.maximum(inst, 1.0)
        drop = (mean_inst >= 4)[:, None] & (cnt < 2)
        distinct = distinct & ~drop
        acc = jnp.where(distinct[..., None], acc, jnp.uint32(FULL))
        cnt = jnp.where(distinct, cnt, 0)
        acc, ex = kmers.sort_kmers(acc, [cnt])
        cnt = ex[0]
        distinct = ~jnp.all(acc == jnp.uint32(FULL), axis=-1)
    elif min_count > 1:
        keep = distinct & (cnt >= min_count)
        acc = jnp.where(keep[..., None], acc, jnp.uint32(FULL))
        cnt = jnp.where(keep, cnt, 0)
        acc, ex = kmers.sort_kmers(acc, [cnt])
        cnt = ex[0]
        distinct = ~jnp.all(acc == jnp.uint32(FULL), axis=-1)
    return acc, cnt, distinct


@jax.jit
def _merge_chunk_impl(acc, acc_cnt, limbs_new, cnt_new):
    G, M, nl = acc.shape
    both = jnp.concatenate([acc, limbs_new], axis=1)
    cnts = jnp.concatenate([acc_cnt, cnt_new], axis=1)
    ops = [both[..., l] for l in range(nl)] + [cnts]
    res = jax.lax.sort(tuple(ops), dimension=1, num_keys=nl)
    s = jnp.stack(res[:nl], axis=-1)
    scnt = res[nl]
    first = kmers.unique_mask(s)
    keep = first & ~jnp.all(s == jnp.uint32(FULL), axis=-1)
    # segment-sum counts of equal keys: total prefix sums at run starts
    csum = jnp.cumsum(scnt, axis=-1)
    P = s.shape[1]
    idx = jnp.arange(P, dtype=jnp.int32)
    nxt = kmers._next_first(first)
    zero = jnp.zeros_like(csum[..., :1])
    c0 = jnp.concatenate([zero, csum], axis=-1)
    seg = jnp.take_along_axis(c0, nxt, axis=-1) - \
        jnp.take_along_axis(c0, jnp.where(first, idx[None, :], 0), axis=-1)
    seg = jnp.where(keep, seg, 0)
    # cumsum-rank scatter compaction (cheaper than a second full-width
    # sort; FULL/0 init makes the tail correct)
    rank = jnp.cumsum(keep, axis=-1) - 1
    tgt = jnp.where(keep, rank, P)
    b = jnp.arange(G, dtype=jnp.int32)[:, None]
    merged = jnp.full((G, P + 1, nl), jnp.uint32(FULL)).at[
        b, tgt].set(s, mode="drop")[:, :P]
    mcnt = jnp.zeros((G, P + 1), jnp.int32).at[
        b, tgt].set(seg, mode="drop")[:, :P]
    return merged[:, :M], mcnt[:, :M]


def _merge_chunk(chunk, clen, acc, acc_cnt, k):
    limbs, valid = kmers.extract_kmers(chunk, clen, k)   # [G, Rc, P, nl]
    limbs = kmers.canonicalize(limbs, k)
    limbs = jnp.where(valid[..., None], limbs, jnp.uint32(FULL))
    G = limbs.shape[0]
    flat = limbs.reshape(G, -1, limbs.shape[-1])
    ones = jnp.where(valid.reshape(G, -1), 1, 0).astype(jnp.int32)
    return _merge_chunk_impl(acc, acc_cnt, flat, ones)


@jax.jit
def _merge_chunk_nocnt_impl(acc, limbs_new):
    """Distinct-set merge WITHOUT multiplicities: when neither
    min_kmer_count nor bubble popping needs counts, the count operand
    and the segment sums are pure overhead — this drops them from the
    block's biggest sort."""
    G, M, nl = acc.shape
    both = jnp.concatenate([acc, limbs_new], axis=1)
    ops = [both[..., l] for l in range(nl)]
    res = jax.lax.sort(tuple(ops), dimension=1, num_keys=nl)
    s = jnp.stack(res, axis=-1)
    first = kmers.unique_mask(s)
    keep = first & ~jnp.all(s == jnp.uint32(FULL), axis=-1)
    P = s.shape[1]
    rank = jnp.cumsum(keep, axis=-1) - 1
    tgt = jnp.where(keep, rank, P)
    b = jnp.arange(G, dtype=jnp.int32)[:, None]
    merged = jnp.full((G, P + 1, nl), jnp.uint32(FULL)).at[
        b, tgt].set(s, mode="drop")[:, :P]
    return merged[:, :M]


def _merge_chunk_nocnt(chunk, clen, acc, k):
    limbs, valid = kmers.extract_kmers(chunk, clen, k)
    limbs = kmers.canonicalize(limbs, k)
    limbs = jnp.where(valid[..., None], limbs, jnp.uint32(FULL))
    G = limbs.shape[0]
    flat = limbs.reshape(G, -1, limbs.shape[-1])
    return _merge_chunk_nocnt_impl(acc, flat)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# hard memory backstop for the auto-grown distinct-k-mer table
# ([G, M, nl] uint32 sort buffers): 4M k-mers per gap ~ a >4 Mb unitig
MAX_AUTO_DISTINCT = 1 << 22


def count_gap_kmers(cfg: Config, reads, read_len, n_reads, k: int,
                    max_distinct: int):
    """Distinct-k-mer counting with auto-growing capacity.

    When ``cfg.max_distinct_kmers`` is 0 (the default: reference-parity
    unbounded, /root/reference/assemble_gaps.py:96-102 `kmc -ci0`), a
    saturated table is retried at double capacity until it fits or the
    memory backstop is hit; a fixed positive config value keeps the
    given bound but WARNS whenever it truncates.
    """
    auto = cfg.max_distinct_kmers == 0
    md = max_distinct if auto else cfg.max_distinct_kmers
    while True:
        kstr, nk, kcnt, sat = gap_distinct_kmers(
            reads, read_len, n_reads, k, md, min_count=cfg.min_kmer_count)
        if not sat.any():
            return kstr, nk, kcnt
        if auto and md < MAX_AUTO_DISTINCT:
            log.warn_cap(
                "kmer_table_grow",
                "distinct k-mer table saturated at %d for %d gap(s); "
                "retrying at %d", md, int(sat.sum()), md * 2)
            md *= 2
            continue
        log.warn_cap(
            "kmer_table_truncated",
            "distinct k-mer table CAP %d truncating %d gap(s) "
            "(k=%d): lexicographically-largest k-mers dropped — raise "
            "max_distinct_kmers or set it to 0 (auto)",
            md, int(sat.sum()), k)
        return kstr, nk, kcnt


def assemble_gap_batch(cfg: Config, reads, read_len, n_reads,
                       max_distinct: int = 1 << 14) -> GapContigs:
    """Run all (k, sub_k) settings over one padded gap batch.

    Output bounds are provably sufficient by default: a unitig over M
    distinct k-mers is at most M+k bases, so ``max_contig_len`` auto =
    next_pow2(M+k) can never truncate; the per-setting unitig count
    auto-doubles on saturation. Fixed config values warn when they bite
    (VERDICT r1 #5 — the reference's Velvet output is unbounded).
    """
    G = reads.shape[0]
    seqs, lens, counts, names = [], [], [], [[] for _ in range(G)]
    # distinct-k-mer tables depend only on k; the reference pairs each
    # k with several sub_k values (configuration.json k 30/40/50 x two
    # velvet sub-ks) — count once per unique k, not once per setting
    kmer_cache: dict = {}
    for (k, sub_k) in cfg.kmers:
        if k not in kmer_cache:
            kmer_cache[k] = count_gap_kmers(cfg, reads, read_len,
                                            n_reads, k, max_distinct)
    for (k, sub_k) in cfg.kmers:
        kstr, nk, kcnt = kmer_cache[k]
        md = kstr.shape[1]
        if cfg.max_contig_len > 0:
            max_len = cfg.max_contig_len
        else:
            max_len = _next_pow2(md + k)
        mu = max(cfg.max_unitigs, 1)
        # DBG working-set caps from the OBSERVED distinct counts: the
        # pointer-doubling gathers scale with the padded node count and
        # the worst-case bound is ~6x the typical one; start near the
        # contiguous-region estimate and auto-grow on overflow.
        nk_max = max(int(np.asarray(nk).max(initial=0)), 1)
        ncap = _next_pow2(2 * nk_max + 4 * k)
        worst = kstr.shape[1] * 2 * (k - sub_k + 1)
        while True:
            useq, ulen, ucnt, n_nodes, n_edges = dbg.assemble_unitigs(
                jnp.asarray(kstr), jnp.asarray(nk), jnp.asarray(kcnt),
                k=k, sub_k=sub_k,
                max_unitigs=mu, max_len=max_len,
                min_len=cfg.min_contig_len,
                pop_bubbles=cfg.bubble_pop_rounds,
                node_cap=min(ncap, worst),
                edge_cap=min(ncap, worst))
            useq, ulen, ucnt = map(np.asarray, (useq, ulen, ucnt))
            over = max(int(np.asarray(n_nodes).max(initial=0)),
                       int(np.asarray(n_edges).max(initial=0)))
            if over > min(ncap, worst) and ncap < worst:
                log.warn_cap(
                    "dbg_node_cap_grow",
                    "DBG node/edge cap %d overflowed (%d distinct, "
                    "k=%d); retrying at %d", ncap, over, k, ncap * 2)
                ncap *= 2
                continue
            if (ucnt >= mu).any() and mu < (1 << 14):
                log.warn_cap(
                    "unitig_slots_grow",
                    "unitig slots saturated at %d for %d gap(s) "
                    "(k=%d); retrying at %d", mu, int((ucnt >= mu).sum()),
                    k, mu * 2)
                mu *= 2
                continue
            break
        if cfg.max_contig_len > 0 and (ulen >= max_len).any():
            log.warn_cap(
                "contig_len_truncated",
                "max_contig_len=%d truncated %d unitig(s) (k=%d): set "
                "max_contig_len=0 (auto) for unbounded output",
                max_len, int((ulen >= max_len).sum()), k)
        seqs.append(useq)
        lens.append(ulen)
        counts.append(ucnt)
        for g in range(G):
            names[g] += [f"{k}_{sub_k}_{i}" for i in range(int(ucnt[g]))]

    # compact per gap: concatenate settings, packing valid contigs first
    C = max(sum(s.shape[1] for s in seqs), 1)
    Lmax = max((s.shape[2] for s in seqs), default=1)
    out_seq = np.full((G, C, Lmax), dna.N, np.int8)
    out_len = np.zeros((G, C), np.int32)
    out_cnt = np.zeros(G, np.int32)
    for g in range(G):
        c = 0
        for si in range(len(seqs)):
            n = int(counts[si][g])
            out_seq[g, c:c + n, :seqs[si].shape[2]] = seqs[si][g, :n]
            out_len[g, c:c + n] = lens[si][g, :n]
            c += n
        out_cnt[g] = c
    return GapContigs(seq=out_seq, length=out_len, count=out_cnt,
                      names=names)
