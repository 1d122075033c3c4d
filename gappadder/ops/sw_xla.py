"""Batched anti-diagonal wavefront affine-gap DP in pure XLA.

Same semantics as sw_host.sw_np (the oracle), vectorized:
  * batch dimension B: independent (query, target) pairs, padded to
    (Lq, Lt) with per-pair lengths;
  * one lax.scan step per anti-diagonal d = i + j; every cell on a
    diagonal is independent, so each step is elementwise work over
    [B, Lq+1] state vectors.

This is the SW kernel on every backend. A hand-written CUDA kernel
was 30-50x faster alone on an H100 but did not move the pipeline's
Assembly stage measurably (PERF.md), so this scan, compiled by XLA, is
the one implementation.

Score-only + best endpoints; traceback for winners happens on host
(sw_host.traceback) — SURVEY.md §7 "Hard parts" #3.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .sw_host import SWParams

NEG = -(1 << 28)


def _shift(x, fill):
    """lane i <- lane i-1, lane 0 <- fill ([B] or scalar)."""
    if jnp.ndim(fill) == 0:
        fill = jnp.full((x.shape[0],), fill, x.dtype)
    return jnp.concatenate([fill[:, None], x[:, :-1]], axis=1)


@functools.partial(jax.jit, static_argnames=("params", "mode", "end_slack"))
def sw_batch(q, qlen, t, tlen, params: SWParams = SWParams(),
             mode: str = "local", end_slack: int = 0):
    """Batched DP scores + best endpoints.

    Args:
      q: int8/int32 [B, Lq] query codes (padding arbitrary).
      qlen: int32 [B] valid lengths.
      t: int8/int32 [B, Lt] target codes.
      tlen: int32 [B].
      params: scoring (gap_open/gap_extend are positive costs).
      mode: 'local' | 'overlap' | 'extend' (see sw_host).

    Returns:
      score, qend, tend: int32 [B]; ends are 1-based consumed lengths
      (cell indices in the DP matrix) of the best-scoring cell.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    L = Lq + 1  # lanes: i = 0..Lq
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)

    lane = jnp.arange(L, dtype=jnp.int32)[None, :]          # [1, L]
    qreg = jnp.concatenate(
        [jnp.full((B, 1), 127, jnp.int32), q], axis=1)      # lane i -> q[i-1]

    free_ends = mode in ("local", "overlap")
    clamp = mode == "local"

    def boundary_row0(d):
        # H[0, j=d]
        if free_ends or mode == "fit":
            return jnp.where(d <= tlen, 0, NEG)
        return jnp.where(d == 0, 0, NEG)  # extend

    def boundary_col0(d=1):
        # H[i=d, 0]
        if free_ends:
            return jnp.int32(0)
        if mode == "fit":  # leading query gap: -(go + (i-1)*ge)
            return jnp.int32(-params.gap_open) - \
                (jnp.asarray(d, jnp.int32) - 1) * params.gap_extend
        return jnp.int32(NEG)

    # init state at d=1
    Hm2 = jnp.where(lane == 0, 0, NEG) * jnp.ones((B, 1), jnp.int32)  # d=0
    Hm1 = jnp.full((B, L), NEG, jnp.int32)
    Hm1 = Hm1.at[:, 0].set(boundary_row0(jnp.full((B,), 1, jnp.int32)))
    Hm1 = Hm1.at[:, 1].set(jnp.where(1 <= qlen, boundary_col0(), NEG))
    Em1 = jnp.full((B, L), NEG, jnp.int32)
    Fm1 = jnp.full((B, L), NEG, jnp.int32)
    tr = jnp.full((B, L), 127, jnp.int32)
    tr = tr.at[:, 0].set(t[:, 0])

    go = params.gap_open
    ge = params.gap_extend

    best0 = (jnp.full((B,), NEG, jnp.int32), jnp.zeros((B,), jnp.int32),
             jnp.zeros((B,), jnp.int32))

    def step(carry, d):
        Hm2, Hm1, Em1, Fm1, tr, best = carry
        # advance target register FIRST: tr[i] = t[d-i-1] for this diag
        tchar = jnp.where(d - 1 < Lt, jnp.take(t, jnp.clip(d - 1, 0, Lt - 1),
                                               axis=1), 127)
        tr = _shift(tr, tchar)
        E = jnp.maximum(Hm1 - go, Em1 - ge)
        F = jnp.maximum(_shift(Hm1, NEG) - go, _shift(Fm1, NEG) - ge)
        s = jnp.where((qreg == tr) & (qreg < 4), params.match, params.mismatch)
        H = jnp.maximum(_shift(Hm2, NEG) + s, jnp.maximum(E, F))
        if clamp:
            H = jnp.maximum(H, 0)

        j = d - lane                                         # [1, L] broadcast
        valid = (lane >= 1) & (lane <= qlen[:, None]) & \
                (j >= 1) & (j <= tlen[:, None])
        H = jnp.where(valid, H, NEG)
        E = jnp.where(valid, E, NEG)
        F = jnp.where(valid, F, NEG)
        # boundaries of THIS diagonal
        row0 = boundary_row0(jnp.full((B,), d, jnp.int32))
        H = jnp.where(lane == 0, row0[:, None], H)
        col0_ok = (lane == d) & (lane <= qlen[:, None])
        H = jnp.where(col0_ok, boundary_col0(d), H)

        # best tracking
        if mode == "overlap":
            endcell = valid & ((lane >= qlen[:, None] - end_slack) |
                               (j >= tlen[:, None] - end_slack))
            cand = jnp.where(endcell, H, NEG)
        elif mode == "fit":
            endcell = valid & (lane == qlen[:, None])
            cand = jnp.where(endcell, H, NEG)
        else:
            cand = jnp.where(valid, H, NEG)
        m = jnp.max(cand, axis=1)
        am = jnp.argmax(cand, axis=1).astype(jnp.int32)
        bs, bi, bd = best
        upd = m > bs
        best = (jnp.where(upd, m, bs), jnp.where(upd, am, bi),
                jnp.where(upd, d, bd))

        return (Hm1, H, E, F, tr, best), None

    ds = jnp.arange(2, Lq + Lt + 1, dtype=jnp.int32)
    (Hm2, Hm1, Em1, Fm1, tr, best), _ = jax.lax.scan(
        step, (Hm2, Hm1, Em1, Fm1, tr, best0), ds)

    score, bi, bd = best
    if mode == "fit":
        # oracle also considers the all-gap cell H[qlen, 0]
        fb = -(params.gap_open + (qlen - 1) * params.gap_extend)
        empty = score < fb
        score = jnp.where(empty, fb, score)
        bi = jnp.where(empty, qlen, bi)
        bd = jnp.where(empty, qlen, bd)
    if mode == "extend":
        # oracle includes the (0,0) origin (score 0) as a candidate
        empty = score < 0
        score = jnp.where(empty, 0, score)
        bi = jnp.where(empty, 0, bi)
        bd = jnp.where(empty, 0, bd)
    if mode == "local":
        # empty alignment scores 0
        empty = score < 0
        score = jnp.maximum(score, 0)
        bi = jnp.where(empty, 0, bi)
        bd = jnp.where(empty, 0, bd)
    if mode == "overlap":
        # when no interior end-cell reaches 0 the oracle's best is the
        # zero-score boundary cell H[qlen, 0] (free leading gap)
        empty = score < 0
        score = jnp.where(empty, 0, score)
        bi = jnp.where(empty, qlen, bi)
        bd = jnp.where(empty, qlen, bd)
    return score, bi, bd - bi
