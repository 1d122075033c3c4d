"""A/B microbench of the DBG assemble block at the production shape.

Variants:
  persetting  one assemble_unitigs call per (k, sub_k)  (round-4 path)
  multi       one assemble_unitigs_multi call (all settings batched)

Usage: python scripts/dbgbench.py [--gaps=16] [--variant=both]
Prints one JSON line per variant: the median of warmed calls, each
waited for with block_until_ready.
"""

import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

import numpy as np


def main():
    import jax
    gaps = 16
    variants = ["persetting", "multi"]
    for a in sys.argv[1:]:
        if a.startswith("--gaps="):
            gaps = int(a.split("=")[1])
        if a.startswith("--variant="):
            v = a.split("=")[1]
            if v != "both":
                variants = [v]
    from gappadder.utils.jaxcache import setup_compile_cache
    from gappadder.utils.meters import time_blocked
    setup_compile_cache()

    import jax.numpy as jnp
    from gappadder import dna
    from gappadder.ops import dbg
    from gappadder.parallel.slice import SliceDims
    from slice_bench import PRODUCTION_KSET

    # production-shape distinct-kmer tables: synthesize G gaps of
    # contiguous region sequence, take their distinct canonical k-mers
    rng = np.random.default_rng(0)
    dims = SliceDims(n_shards=1, n_gaps=gaps, gaps_per_shard=gaps,
                     entry_cap=1, reads_per_gap=1, kset=PRODUCTION_KSET,
                     max_distinct=2048)
    M = dims.max_distinct
    kstrs, nks, kcnts = {}, {}, {}
    for k in sorted({k for k, _ in dims.kset}):
        arr = np.full((gaps, M, k), dna.N, np.int8)
        nk = np.zeros(gaps, np.int32)
        for g in range(gaps):
            region = rng.integers(0, 4, 1184).astype(np.int8)
            seen = set()
            rows = []
            for i in range(len(region) - k + 1):
                s = bytes(region[i:i + k])
                rc = bytes(dna.revcomp(region[i:i + k]))
                key = min(s, rc)
                if key not in seen:
                    seen.add(key)
                    rows.append(np.frombuffer(key, np.int8))
            rows = rows[:M]
            for j, r in enumerate(rows):
                arr[g, j] = r
            nk[g] = len(rows)
        kstrs[k] = jnp.asarray(arr)
        nks[k] = jnp.asarray(nk)
        kcnts[k] = jnp.asarray(np.ones((gaps, M), np.int32))

    ncap = 4096  # right-sized: ~2*region_len + margin (the shipped path derives this from observed nk)
    mu, Lc, ml = 4, 2048, 40

    def run_persetting(w):
        outs = []
        for (k, sk) in dims.kset:
            outs.append(dbg.assemble_unitigs(
                kstrs[k], nks[k] + w, kcnts[k], k=k, sub_k=sk,
                max_unitigs=mu, max_len=Lc, min_len=ml,
                node_cap=ncap,
                edge_cap=ncap))
        return outs

    def run_multi(w):
        return dbg.assemble_unitigs_multi(
            tuple(kstrs[k] for k, _ in dims.kset),
            tuple(nks[k] + w for k, _ in dims.kset),
            tuple(kcnts[k] for k, _ in dims.kset),
            settings=dims.kset, max_unitigs=mu, max_len=Lc,
            min_len=ml, node_cap=ncap, edge_cap=ncap)

    for v in variants:
        fn = jax.jit(run_persetting if v == "persetting" else run_multi)
        t = time_blocked(lambda: fn(jnp.int32(0)))
        print(json.dumps({
            "variant": v, "gaps": gaps, "ms": t * 1e3,
            "gaps_per_s_equiv": gaps / t,
            "backend": jax.default_backend(),
            "device": jax.devices()[0].device_kind}), flush=True)


if __name__ == "__main__":
    main()
