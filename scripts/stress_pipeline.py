"""Whole-pipeline stress run on a synthetic draft (BASELINE config 3
shape, scaled down): N scaffolds, many gaps, one PE library.

Usage:
  python scripts/stress_pipeline.py [n_gaps] [scaffold_kb]
      [--dir=PATH] [--sim-only | --run-only] [--repeat=N]

--repeat=N reruns the pipeline N times (fresh workspace each) and
reports per-stage median (min..max). JAX's platform comes from the
environment (JAX_PLATFORMS=cpu for a CPU run).

Default runs simulate + pipeline in one process. For honest peak-RSS
measurement of the PIPELINE (VERDICT r2 missing #4: bounded-memory
collect), split phases: `--dir=D --sim-only` writes the scenario to D,
then a fresh process with `--dir=D --run-only` runs the pipeline — its
ru_maxrss excludes the simulator's own memory spike.

Prints per-stage timings, closure rate, gaps/s, and peak RSS.
"""

import os
import pathlib
import resource
import sys
import tempfile
import time

_ROOT = pathlib.Path(os.environ.get("GPT_ROOT",
                                    pathlib.Path(__file__).resolve().parent.parent)
                     if "__file__" in globals() else os.getcwd())
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / "tests"))

import numpy as np


def simulate(tmp, n_gaps, scaf_kb, rng):
    from gappadder.io import bam as bam_io, fasta
    import read_simulator

    n_scaf = max(1, n_gaps // 8)
    gaps_per_scaf = n_gaps // n_scaf
    L = scaf_kb * 1000

    truths, drafts, spans_all = [], [], []
    for s in range(n_scaf):
        truth = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
        spans = []
        step = L // (gaps_per_scaf + 1)
        for g in range(gaps_per_scaf):
            gs = (g + 1) * step
            glen = int(rng.integers(100, 400))
            spans.append((gs, gs + glen))
        d = list(truth)
        for a, b in spans:
            d[a:b] = "N" * (b - a)
        truths.append(truth)
        drafts.append("".join(d))
        spans_all.append(spans)

    fasta.write_fasta(str(tmp / "draft.fa"),
                      [(f"scaf{i}", d) for i, d in enumerate(drafts)])
    fasta.write_fasta(str(tmp / "truth.fa"),
                      [(f"scaf{i}", t) for i, t in enumerate(truths)])

    t0 = time.time()
    all_recs, lfq, rfq = [], [], []
    coverage_pairs = int(30 * L / 200)
    for si, (truth, spans) in enumerate(zip(truths, spans_all)):
        recs, lf, rf = read_simulator.simulate(
            truth, spans, coverage_pairs, rng, read_len=100,
            insert=300, std=30)
        for r in recs:
            r["tid"] = si
            r["mtid"] = si
            r["name"] = f"s{si}_" + r["name"]
        all_recs += recs
        lfq += [(f"s{si}_{n}", s) for n, s in lf]
        rfq += [(f"s{si}_{n}", s) for n, s in rf]
    all_recs.sort(key=lambda r: (r["tid"], r["pos"]))
    bam_io.write_bam(str(tmp / "lib.bam"),
                     [(f"scaf{i}", L) for i in range(n_scaf)], all_recs)
    for path, entries in ((tmp / "l.fq", lfq), (tmp / "r.fq", rfq)):
        with open(path, "w") as fh:
            for name, seq in entries:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    print(f"simulate: {time.time()-t0:.1f}s "
          f"({len(all_recs)} records, {n_gaps} gaps)")


def run_pipeline(tmp, repeat: int = 1):
    from gappadder import dna
    from gappadder.config import Config, Library, DeviceParams
    from gappadder.io import fasta
    from gappadder.pipeline import collect, preprocess, run
    from gappadder.pipeline.workspace import Workspace

    genome = fasta.read_fasta(str(tmp / "draft.fa"))
    truth = fasta.read_fasta(str(tmp / "truth.fa"))

    def rss():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    stages = ("preprocess", "collect", "assembly+pick")
    times = {s: [] for s in stages}
    for rep in range(repeat):
        wf = str(tmp / ("work" if repeat == 1 else f"work_r{rep}"))
        cfg = Config(
            draft_genome=str(tmp / "draft.fa"), min_gap_size=50,
            flank_length=150,
            working_folder=wf, kmers=((25, 21), (31, 27)),
            libraries=(Library(bam=str(tmp / "lib.bam"), insert_size=300,
                               std=30, left_fq=str(tmp / "l.fq"),
                               right_fq=str(tmp / "r.fq")),),
            device=DeviceParams())
        ws = Workspace(cfg.workdir)

        t0 = time.time()
        gaps = preprocess.run_preprocess(cfg, ws, genome=genome)
        t1 = time.time()
        rec, readsets = collect.run_collect(cfg, ws, genome=genome)
        t2 = time.time()
        fills, exts, _ = run.run_assembly_and_pick(
            cfg, ws, rec=rec, readsets=readsets, genome=genome)
        t3 = time.time()
        for s, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            times[s].append(dt)
        if rep == 0:
            print(f"preprocess: {t1-t0:.1f}s ({len(gaps['start'])} gaps) "
                  f"[peak RSS {rss():.2f} GB]")
            print(f"collect: {t2-t1:.1f}s ({len(rec['gap'])} recruits) "
                  f"[peak RSS {rss():.2f} GB]")
            print(f"assembly+pick: {t3-t2:.1f}s "
                  f"({len(fills)} closed, {len(exts)} extended) "
                  f"[peak RSS {rss():.2f} GB]")

    if repeat > 1:
        # per-stage median over repeats with the min..max spread
        for s in stages:
            ts = sorted(times[s])
            med = ts[len(ts) // 2]
            print(f"{s}: median {med:.1f}s over {repeat} runs "
                  f"(min {ts[0]:.1f} max {ts[-1]:.1f})")

    ok = 0
    for g, (seq, _name) in fills.items():
        si = int(gaps["scaffold"][g])
        gs = int(gaps["local_start"][g])
        ge = int(gaps["local_end"][g])
        t = truth.scaffold(si)
        margin = cfg.flank_margin
        want = dna.decode(t[gs - margin: ge + margin])
        if dna.decode(seq) == want:
            ok += 1
    n = len(gaps["start"])
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    med_e2e = (sorted(times["collect"])[repeat // 2]
               + sorted(times["assembly+pick"])[repeat // 2])
    print(f"closure: {len(fills)}/{n} picked, {ok}/{n} bit-exact, "
          f"{n/med_e2e:.2f} gaps/s end-to-end, peak RSS {rss_gb:.2f} GB")


def main():
    from gappadder.utils.jaxcache import setup_compile_cache
    setup_compile_cache()
    sim_only = "--sim-only" in sys.argv
    run_only = "--run-only" in sys.argv
    tmp = None
    repeat = 1
    for a in list(sys.argv[1:]):
        if a.startswith("--dir="):
            tmp = pathlib.Path(a.split("=", 1)[1])
            sys.argv.remove(a)
        elif a.startswith("--repeat="):
            repeat = int(a.split("=", 1)[1])
            sys.argv.remove(a)
    for flag in ("--sim-only", "--run-only"):
        if flag in sys.argv:
            sys.argv.remove(flag)
    n_gaps = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    scaf_kb = int(sys.argv[2]) if len(sys.argv) > 2 else 25

    if tmp is None:
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="gpt_stress_"))
    tmp.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    if not run_only:
        simulate(tmp, n_gaps, scaf_kb, rng)
    if not sim_only:
        run_pipeline(tmp, repeat=repeat)


if __name__ == "__main__":
    main()
