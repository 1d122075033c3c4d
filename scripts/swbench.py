"""SW kernel bench: sw_xla at given widths, timed with
block_until_ready (median of warmed calls).

    python scripts/swbench.py [--pairs 1024] [--lq 300] [--lt 1024]
                              [--mode local] [--slack 0]

Prints one JSON line with the device, the time and GCUPS. Needs a GPU;
fails otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def random_pairs(rng, B, Lq, Lt):
    """Pairs whose targets embed a mutated piece of the query, with
    lengths drawn from [L/2, L] and a sprinkle of N codes."""
    ql = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    tl = rng.integers(Lt // 2, Lt + 1, B).astype(np.int32)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    for b in range(B):
        k = int(min(ql[b], tl[b]) * rng.uniform(0.3, 0.9))
        qo = int(rng.integers(0, ql[b] - k + 1))
        to = int(rng.integers(0, tl[b] - k + 1))
        piece = q[b, qo:qo + k].copy()
        mut = rng.random(k) < 0.05
        piece[mut] = rng.integers(0, 4, int(mut.sum()))
        t[b, to:to + k] = piece
    q[rng.random(q.shape) < 0.002] = 4
    t[rng.random(t.shape) < 0.002] = 4
    return q, ql, t, tl


def measure(B: int, Lq: int, Lt: int, mode: str = "local",
            end_slack: int = 0, params=None, seed: int = 0) -> dict:
    """Warmed seconds of sw_xla on one random batch."""
    import jax
    import jax.numpy as jnp
    from gappadder.ops import sw_xla
    from gappadder.ops.sw_host import BWA_PARAMS
    from gappadder.utils.meters import time_blocked

    params = params or BWA_PARAMS
    q, ql, t, tl = random_pairs(np.random.default_rng(seed), B, Lq, Lt)
    args = tuple(jnp.asarray(a) for a in (q, ql, t, tl))
    t_xla = time_blocked(
        lambda: sw_xla.sw_batch(*args, params, mode, end_slack=end_slack))
    cells = float(np.sum(ql.astype(np.int64) * tl))
    d = jax.devices()[0]
    return {"device": d.device_kind, "platform": d.platform,
            "pairs": B, "lq": Lq, "lt": Lt, "mode": mode,
            "end_slack": end_slack, "xla_s": t_xla,
            "xla_gcups": cells / t_xla / 1e9}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1024)
    ap.add_argument("--lq", type=int, default=300)
    ap.add_argument("--lt", type=int, default=1024)
    ap.add_argument("--mode", default="local",
                    choices=["local", "overlap", "fit", "extend"])
    ap.add_argument("--slack", type=int, default=0)
    args = ap.parse_args()
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"swbench needs a GPU; JAX backend is "
                 f"{jax.default_backend()}")
    print(json.dumps(measure(args.pairs, args.lq, args.lt, args.mode,
                             args.slack)))


if __name__ == "__main__":
    main()
