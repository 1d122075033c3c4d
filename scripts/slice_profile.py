"""Per-block timing of the fused slice step.

Times nested prefixes of the step pipeline (classify | +route/group |
+payload gather | +kmers | +assemble | full step incl. pick) at bench
shapes, each the median of warmed steps waited for with
block_until_ready; consecutive differences give per-block cost.

Usage: python scripts/slice_profile.py [--gaps=16] [--skew] [--production]
Prints one JSON dict {block: seconds_per_step}.
"""

import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main():
    import jax
    gaps = 16
    skew = "--skew" in sys.argv
    production = "--production" in sys.argv
    for a in sys.argv[1:]:
        if a.startswith("--gaps="):
            gaps = int(a.split("=")[1])
    from gappadder.utils.jaxcache import setup_compile_cache
    setup_compile_cache()

    import jax.numpy as jnp
    from gappadder import dna
    from gappadder.parallel import slice as sl
    from gappadder.parallel.mesh import make_mesh
    from gappadder.utils.meters import time_blocked
    sys.path.insert(0, os.path.join(_ROOT, "scripts"))
    from slice_bench import bench_scenario

    mesh = make_mesh(shape=(1,), axes=("dp",), devices=jax.devices()[:1])
    dims, args = bench_scenario(1, gaps, skew=skew, production=production)
    placed = sl.place_args(mesh, args)

    def prefix_fn(upto):
        """upto: classify < route < gather < assemble < full."""
        def fn(*a):
            (tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
             name_hi, name_lo,
             wtid, wstart, wend, wgap, wedge, gap_start, gap_end,
             tbl_hi, tbl_lo, tbl_row, tbl_side,
             reads_tbl, reads_len, flank_l, flank_r, flank_ll,
             flank_rl) = a
            axis = "dp"
            entries, _mates, counts3 = sl._classify_extract(
                tid, pos, flag, mapq, mtid, mpos, tlen, lclip, rclip,
                name_hi, name_lo, wtid, wstart, wend, wgap, wedge,
                gap_start, gap_end, dims=dims)
            if upto == "classify":
                return counts3.sum() + entries[0].sum()
            rowtab, hqtab, n_reads, (nr, nv) = sl._route_and_group(
                entries, tbl_hi, tbl_lo, tbl_row, tbl_side,
                dims=dims, axis=axis)
            if upto == "route":
                return rowtab.sum() + n_reads.sum()
            Ntot = reads_tbl.shape[0]
            safe = jnp.clip(rowtab, 0, Ntot - 1)
            live = rowtab >= 0
            seq = jnp.where(live[..., None], reads_tbl[safe], dna.N)
            rlen = jnp.where(live, reads_len[safe], 0)
            if upto == "gather":
                return seq.astype(jnp.int32).sum() + rlen.sum()
            if upto == "kmers":
                # counting stage only, all (k, sub_k) settings
                s = jnp.zeros((), jnp.int32)
                for (k, _sk) in dims.kset:
                    acc, kstr, nk, kcnt, _d = sl._distinct_kmers(
                        seq, rlen, k, dims)
                    s = s + nk.sum() + kstr.astype(jnp.int32).sum()
                return s
            useq, ulen, ucnt, hist, _ov = sl._assemble_block(
                seq, rlen, dims)
            if upto == "assemble":
                return ulen.sum() + ucnt.sum()
            N = dims.n_shards
            me = jax.lax.axis_index(axis)
            Gl = dims.gaps_per_shard
            myg = jnp.clip(me + jnp.arange(Gl) * N, 0, dims.n_gaps - 1)
            score, qend, tend = sl._pick_score_block(
                useq, ulen, flank_l[myg], flank_r[myg], flank_ll[myg],
                flank_rl[myg], dims)
            return score.sum() + ulen.sum()
        return fn

    def step_time(fn):
        from jax.sharding import PartitionSpec as P
        step = jax.jit(jax.shard_map(fn, mesh=mesh,
                                     in_specs=sl.step_specs(mesh)[0],
                                     out_specs=P(), check_vma=False))
        return time_blocked(lambda: step(*placed))

    out = {"backend": jax.default_backend(),
           "device": jax.devices()[0].device_kind, "gaps": gaps,
           "skew": skew, "production": production}
    prev = 0.0
    for b in ("classify", "route", "gather", "kmers", "assemble",
              "full"):
        t = step_time(prefix_fn(b))
        out[b + "_s"] = round(t, 6)
        out[b + "_delta_ms"] = round((t - prev) * 1e3, 3)
        prev = t
    out["gaps_per_s_full"] = round(gaps / out["full_s"], 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
