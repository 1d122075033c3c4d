"""Distributed routing: gap-home sharding via all-to-all collectives.

The reference dispatches each recruited read into its gap's FASTQ file
on one node (/root/reference/run_multi_threads_discordant.py:194-241).
The multi-device equivalent: every shard classifies ITS slice of the
alignment records, then recruitment entries are routed over the
interconnect to the shard that OWNS the gap (gap-home = gap % n_shards), so each gap's
whole read set lands on one shard and per-gap dedup + assembly stay
purely local afterwards (SURVEY.md §7 hard part 6).

The route is jax.lax.all_to_all over [n_shards, cap]-padded buckets
plus a compaction sort, run INSIDE shard_map; counts are exchanged via
all_gather of the per-destination send-count vector ([src, dst]
matrix), from which each shard derives its receive counts. Rows arrive
source-major, stable within a source.

A jax.lax.ragged_all_to_all route (exact bytes, no padding) was tried
on four H100s: it agreed with this one row for row but took 0.85 ms
against 0.62 ms at 4096 rows per shard, so only the dense route is
kept.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def send_tables(dest, valid, n_shards: int):
    """Per-shard routing tables.

    Args:
      dest: int32 [cap] destination shard of each local row.
      valid: bool [cap] live-row mask (padding rows are not sent).

    Returns (order, key_sorted, send, in_off):
      order: int32 [cap] stable sort permutation grouping rows by
        destination (invalid rows last);
      key_sorted: int32 [cap] destination of each sorted row
        (n_shards for invalid);
      send: int32 [n_shards] rows bound for each destination;
      in_off: int32 [n_shards] exclusive prefix sums of send (the chunk
        starts inside the sorted payload).
    """
    cap = dest.shape[0]
    key = jnp.where(valid, dest, n_shards).astype(jnp.int32)
    order = jnp.argsort(key, stable=True)
    send = jnp.zeros(n_shards, jnp.int32).at[
        jnp.where(valid, dest, 0)].add(valid.astype(jnp.int32), mode="drop")
    in_off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(send)[:-1]]).astype(jnp.int32)
    return order, key[order], send, in_off


def route_shard(payloads, dest, valid, *, axis: str, n_shards: int,
                out_cap: int):
    """Route rows to their destination shard (call inside shard_map).

    Args:
      payloads: tuple of arrays sharing the leading [cap] dim (1-D or
        2-D rows both fine).
      dest: int32 [cap] destination shard per row.
      valid: bool [cap].
      out_cap: static per-shard receive capacity. Overflowing rows are
        dropped deterministically from the highest source ranks.

    Returns (routed, src, n_recv):
      routed: tuple of [out_cap, ...] arrays, rows packed source-major
        (stable within each source shard);
      src: int32 [out_cap] source shard of each received row (-1 pad);
      n_recv: int32 [1] RAW demand (pre-clamp): a value > out_cap means
        rows were dropped; min(n_recv, out_cap) rows were delivered.
    """
    if n_shards == 1:
        # single-shard fast path: routing degenerates to valid-first
        # stable compaction (the same row order: source-major of one
        # source); skips the all_gather + all_to_all dispatches
        cap = dest.shape[0]
        order = jnp.argsort(~valid, stable=True)[:out_cap]
        nv = jnp.sum(valid).astype(jnp.int32)
        ncap32 = jnp.minimum(nv, out_cap)
        live = jnp.arange(out_cap) < ncap32
        outs = []
        for p in payloads:
            fill = -1 if jnp.issubdtype(p.dtype, jnp.signedinteger) else 0
            res = p[order]
            if res.shape[0] < out_cap:
                pad_shape = (out_cap - res.shape[0],) + res.shape[1:]
                res = jnp.concatenate(
                    [res, jnp.full(pad_shape, fill, p.dtype)])
            res = jnp.where(
                live.reshape((-1,) + (1,) * (res.ndim - 1)), res,
                jnp.full(res.shape[1:], fill, p.dtype))
            outs.append(res)
        src = jnp.where(live, 0, -1).astype(jnp.int32)
        return tuple(outs), src, nv[None]

    order, key_sorted, send, in_off = send_tables(dest, valid, n_shards)
    me = jax.lax.axis_index(axis)
    mat = jax.lax.all_gather(send, axis)              # [src, dst]
    # overflow policy: a destination keeps at most out_cap rows,
    # dropped deterministically from the HIGHEST source ranks — clamp
    # each source's contribution to the space left after all
    # lower-ranked sources (`allowed` is the same matrix on every shard)
    cum = (jnp.cumsum(mat, axis=0) - mat).astype(jnp.int32)  # excl. prefix
    allowed = jnp.clip(jnp.minimum(mat, out_cap - cum), 0, None)
    recv = allowed[:, me].astype(jnp.int32)           # from each source
    # RAW demand (pre-clamp): n_recv > out_cap tells the caller rows
    # were dropped; min(n_recv, out_cap) rows are actually delivered
    n_recv = jnp.sum(mat[:, me]).astype(jnp.int32)[None]
    src_payload = jnp.broadcast_to(me, dest.shape).astype(jnp.int32)

    # ---- [n_shards, cap] buckets + all_to_all + compaction ------------
    cap = dest.shape[0]
    if out_cap > n_shards * cap:
        raise ValueError(
            f"route: out_cap={out_cap} exceeds the maximum "
            f"receivable rows n_shards*cap={n_shards * cap}; lower "
            "out_cap or pad the per-shard payload")
    rank = jnp.arange(cap, dtype=jnp.int32) - in_off[
        jnp.clip(key_sorted, 0, n_shards - 1)]
    rank = jnp.where(key_sorted < n_shards, rank, cap)  # invalid -> dropped
    d_idx = jnp.clip(key_sorted, 0, n_shards - 1)

    recv_rank = jnp.arange(cap, dtype=jnp.int32)[None, :]
    keep = recv_rank < recv[:, None]                    # [n_shards, cap]
    flat_keep = keep.reshape(-1)
    order2 = jnp.argsort(~flat_keep, stable=True)[:out_cap]

    delivered = jnp.sum(recv)
    outs = []
    for p in tuple(payloads) + (src_payload,):
        ps = p[order]
        fill = -1 if jnp.issubdtype(p.dtype, jnp.signedinteger) else 0
        buf = jnp.full((n_shards, cap) + p.shape[1:], fill, p.dtype)
        buf = buf.at[d_idx, rank].set(ps, mode="drop")
        got = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0)
        flat = got.reshape((n_shards * cap,) + p.shape[1:])
        res = flat[order2]
        pad_row = jnp.full(res.shape[1:], fill, p.dtype)
        res = jnp.where(
            (jnp.arange(out_cap) < delivered).reshape(
                (-1,) + (1,) * (res.ndim - 1)),
            res, pad_row)
        outs.append(res)
    return tuple(outs[:-1]), outs[-1], n_recv


def make_router(mesh, n_payloads: int, *, out_cap: int):
    """Host-callable jitted router over `mesh` (flattened axes = dp).

    Returns fn(payloads_tuple, dest, valid) -> (routed, src, n_recv)
    where inputs are GLOBAL arrays sharded along the leading dim and
    outputs keep that sharding ([n_shards*out_cap] rows global).
    """
    axes = tuple(mesh.axis_names)
    n_shards = 1
    for a in axes:
        n_shards *= mesh.shape[a]
    dp = P(axes)

    def fn(payloads, dest, valid):
        return route_shard(payloads, dest, valid, axis=axes[0] if
                           len(axes) == 1 else axes, n_shards=n_shards,
                           out_cap=out_cap)

    in_specs = (tuple([dp] * n_payloads), dp, dp)
    out_specs = (tuple([dp] * n_payloads), dp, dp)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def place_dp(mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P(tuple(mesh.axis_names))))
