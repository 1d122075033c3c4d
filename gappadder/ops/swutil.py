"""Shape-bucketed dispatch for the SW kernel (ops/sw_xla.py).

Every ragged alignment batch (pick, merge, rescue, eval) funnels
through here: batch size and sequence lengths are padded up to
power-of-two buckets so jit caches stay warm instead of recompiling
per distinct shape.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import dna
from .sw_host import SWParams
from .sw_xla import sw_batch

# Bucket floors. They bound the number of compiled shapes for small
# batches. sw_xla runs one scan step per anti-diagonal (Lq + Lt steps),
# so the length floors stay small: padding adds steps, not just lanes.
B_FLOOR = 64
LQ_FLOOR = 32
LT_FLOOR = 128


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def sw_pairs(queries, qlens, targets, tlens, params: SWParams,
             mode: str, end_slack: int = 0):
    """Aligned scores for padded arrays with shape bucketing.

    queries [B, Lq] int8, targets [B, Lt] int8 (+ lens). Returns
    numpy (score, qend, tend) of length B.
    """
    B, Lq = queries.shape
    Lt = targets.shape[1]
    Bb = _bucket(max(B, 1), B_FLOOR)
    Lqb = _bucket(max(Lq, 1), LQ_FLOOR)
    Ltb = _bucket(max(Lt, 1), LT_FLOOR)
    qp = np.full((Bb, Lqb), dna.N, np.int8)
    tp = np.full((Bb, Ltb), dna.N, np.int8)
    qp[:B, :Lq] = queries
    tp[:B, :Lt] = targets
    qlp = np.zeros(Bb, np.int32)
    tlp = np.zeros(Bb, np.int32)
    qlp[:B] = qlens
    tlp[:B] = tlens

    s, qe, te = sw_batch(jnp.asarray(qp), jnp.asarray(qlp), jnp.asarray(tp),
                         jnp.asarray(tlp), params, mode, end_slack=end_slack)
    out = np.asarray(jnp.stack([s, qe, te]).astype(jnp.int32))
    return out[0, :B], out[1, :B], out[2, :B]


def sw_ragged(queries, targets, params: SWParams, mode: str,
              end_slack: int = 0):
    """Ragged list-of-arrays wrapper over sw_pairs, grouping pairs by
    query-length bucket so short pairs don't pay for the longest one."""
    if not queries:
        z = np.zeros(0, np.int64)
        return z, z, z
    B = len(queries)
    out_s = np.zeros(B, np.int64)
    out_qe = np.zeros(B, np.int64)
    out_te = np.zeros(B, np.int64)
    groups: dict[int, list[int]] = {}
    for i, q in enumerate(queries):
        groups.setdefault(_bucket(max(len(q), 1), LQ_FLOOR), []).append(i)
    for _, idxs in sorted(groups.items()):
        Lq = max(len(queries[i]) for i in idxs)
        Lt = max(len(targets[i]) for i in idxs)
        qa = np.full((len(idxs), max(Lq, 1)), dna.N, np.int8)
        ta = np.full((len(idxs), max(Lt, 1)), dna.N, np.int8)
        ql = np.zeros(len(idxs), np.int32)
        tl = np.zeros(len(idxs), np.int32)
        for r, i in enumerate(idxs):
            q, t = queries[i], targets[i]
            qa[r, :len(q)] = q
            ta[r, :len(t)] = t
            ql[r] = len(q)
            tl[r] = len(t)
        s, qe, te = sw_pairs(qa, ql, ta, tl, params, mode, end_slack)
        out_s[idxs] = s
        out_qe[idxs] = qe
        out_te[idxs] = te
    return out_s, out_qe, out_te
