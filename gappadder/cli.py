"""CLI: drop-in equivalent of the reference's main.py.

    gappadder -c {Clean,All,Preprocess,Collect,Assembly,Patch} -g config.json

Same command names and JSON schema as the reference
(/root/reference/main.py:15-23); `Patch` is additionally wired in
(the reference leaves put_gap_seq_back_to_scaffold.py as a manual
step).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="gappadder",
                                description="genome gap closing on JAX")
    p.add_argument("-c", "--command", required=True,
                   choices=["Clean", "All", "Preprocess", "Collect",
                            "Assembly", "Patch", "Evaluate"])
    p.add_argument("-g", "--config", required=True)
    p.add_argument("--parity-files", action="store_true",
                   help="also write reference-layout text/FASTA files")
    p.add_argument("--finished", metavar="FASTA", default=None,
                   help="finished genome for Evaluate (truth extraction)")
    p.add_argument("--force", action="store_true",
                   help="re-run stages even when the workspace manifest "
                        "marks them done for this config")
    p.add_argument("--trace", metavar="LOGDIR", default=None,
                   help="write a JAX profiler trace for device timelines")
    p.add_argument("--coordinator", default=os.environ.get(
        "GAPPADDER_DIST_COORD"), metavar="HOST:PORT",
        help="jax.distributed coordinator; enables multi-process SPMD "
             "execution of the pipeline (see parallel/mp.py)")
    p.add_argument("--num-processes", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_NPROCS", "0")))
    p.add_argument("--process-id", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_PROCID", "0")))
    p.add_argument("--cpu-devices", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_CPU_DEVICES", "0")),
        help="with --coordinator: use the CPU backend with this many "
             "virtual devices per process (gloo collectives; test path)")
    args = p.parse_args(argv)

    # distributed init must precede the pipeline imports: module-level
    # jnp constants initialize the backend, and platform/collective
    # config only takes effect before that
    from .parallel import mp
    if args.coordinator:
        mp.init_distributed(args.coordinator, args.num_processes,
                            args.process_id,
                            local_cpu_devices=args.cpu_devices)

    from .config import load_config
    from .io import fasta
    from .pipeline import collect, patch, preprocess, run
    from .pipeline.workspace import Workspace, config_hash
    from .utils.jaxcache import setup_compile_cache
    from .utils.meters import Meters, device_trace

    setup_compile_cache()
    meters = Meters()

    cfg = load_config(args.config)
    ws = Workspace(cfg.workdir)
    cmd = args.command
    chash = config_hash(cfg)

    if cmd in ("Clean",):
        shutil.rmtree(cfg.workdir, ignore_errors=True)
        return 0

    def wants(stage, name):
        if cmd not in (stage, "All"):
            return False
        if not args.force and ws.is_done(name, chash):
            print(f"[{name}] up-to-date (use --force to re-run)")
            return False
        return True

    genome = fasta.read_fasta(cfg.draft_genome)
    with device_trace(args.trace):
        if wants("Preprocess", "preprocess"):
            with meters.stage("preprocess") as m:
                table = preprocess.run_preprocess(
                    cfg, ws, genome=genome,
                    write_parity_files=args.parity_files)
                m["gaps"] = len(table["start"])
            print(f"[preprocess] {m['gaps']} gaps")
            mp.barrier("preprocess")   # later stages read proc-0 writes
        if wants("Collect", "collect"):
            with meters.stage("collect") as m:
                rec, _ = collect.run_collect(
                    cfg, ws, genome=genome,
                    write_parity_files=args.parity_files)
                m["recruits"] = len(rec["gap"])
            print(f"[collect] {m['recruits']} recruited read assignments")
            mp.barrier("collect")
        if wants("Assembly", "assembly"):
            with meters.stage("assembly") as m:
                fills, exts, _ = run.run_assembly_and_pick(cfg, ws,
                                                           genome=genome)
                m["closed"] = len(fills)
                m["extended"] = len(exts)
            print(f"[assembly] {m['closed']} gaps closed, "
                  f"{m['extended']} extended -> "
                  f"{ws.path('picked_seqs.fa')}")
            mp.barrier("assembly")
        if cmd == "Evaluate":
            if not args.finished:
                print("Evaluate needs --finished <genome.fa>",
                      file=sys.stderr)
                return 2
            _evaluate(cfg, ws, args.finished)
        if cmd in ("Patch", "All"):
            with meters.stage("patch") as m:
                gaps = ws.load_arrays("gaps")
                fills = _fills_from_picked(ws, gaps)
                recs = patch.patch_scaffolds(genome, gaps, fills,
                                             margin=cfg.flank_margin)
                out = ws.path("filled_scaffolds.fa")
                if mp.is_primary():
                    fasta.write_fasta(out, recs)
                m["filled"] = len(fills)
            print(f"[patch] wrote {out} ({m['filled']} gaps filled)")
            mp.barrier("patch")
    if mp.is_primary():
        meters.dump(ws.path("metrics.json"))
    if cfg.verbose:
        print(meters.report())
    return 0


def _evaluate(cfg, ws, finished_path):
    """statistic_rslt.py equivalent: extract gap truths from a finished
    genome and score the picked fills; writes hit_list.txt and
    closed_gap_length.txt in the reference's spirit."""
    from .io import fasta
    from .tools import evaluate as ev
    from .pipeline.preprocess import gap_ids
    from .parallel import mp
    if not mp.is_primary():
        return
    gaps = ws.load_arrays("gaps")
    finished = fasta.read_fasta(finished_path)
    truths = ev.extract_true_gap_seqs(
        gaps, finished, gaps["flank_left"], gaps["flank_right"],
        (gaps["flank_left_len"], gaps["flank_right_len"]))
    fills = _fills_from_picked(ws, gaps)
    stats = ev.closure_stats(fills, truths)
    ids = gap_ids(gaps)
    with open(ws.path("hit_list.txt"), "w") as fh:
        for g in stats["hit_list"]:
            fh.write(f"{ids[g]}\n")
    with open(ws.path("closed_gap_length.txt"), "w") as fh:
        for ln in stats["closed_lengths"]:
            fh.write(f"{ln}\n")
    print(f"[evaluate] {stats['n_closed']}/{len(fills)} picked fills "
          f"close their gap (truths for {len(truths)}/{len(ids)} gaps) "
          f"-> {ws.path('hit_list.txt')}")


def _fills_from_picked(ws, gaps):
    """Parse picked_seqs.fa (full closures only) back into fill codes."""
    import os
    from .io import fasta
    path = ws.path("picked_seqs.fa")
    fills = {}
    if not os.path.exists(path):
        return fills
    key = {(int(s), int(n)): i
           for i, (s, n) in enumerate(zip(gaps["scaffold"], gaps["number"]))}
    for name, codes in fasta.iter_fasta(path):
        parts = name.split("_")
        if parts[-1] == "extended":
            continue
        gi = key.get((int(parts[0]), int(parts[1])))
        if gi is not None and gi not in fills:
            fills[gi] = codes
    return fills


if __name__ == "__main__":
    sys.exit(main())
