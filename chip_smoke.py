#!/usr/bin/env python3
"""Smoke run of the gap-closing pipeline on an NVIDIA GPU.

    python chip_smoke.py                  # one card: device, kernel, main path
    python chip_smoke.py --four-cards     # four cards: mesh path vs one card

Phases (any failure exits non-zero; nothing falls back to the CPU):

  device   refuses any platform but "gpu"; prints the card, its power
           limit, the JAX version, XLA_FLAGS, the compile cache and the
           native BAM decoder's state.
  kernel   the SW kernel (ops/sw_xla.py) on the card at the pipeline's
           widths in all four modes, against the host oracle
           (sw_host.sw_np) on 64 pairs; warmed time and the compiled
           memory analysis.
  main     a seeded deployment (a draft of N 100 kb scaffolds, 8 gaps of
           100-400 bp each, one 2x100 bp paired-end library at 30x) run
           through `gappadder -c All` in this process; every picked
           fill must equal the planted truth and >= 95% of gaps must
           close. Prints per-stage seconds, compile seconds and peak
           device memory.
  four     (--four-cards only) the same deployment with mesh_shape [4]
           and [1] in one process; the outputs must be byte-equal.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
KSET6 = ((30, 29), (30, 27), (40, 39), (40, 37), (50, 49), (50, 47))
BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class PhaseError(RuntimeError):
    """A phase found a wrong or missing result."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _import_paths() -> None:
    if not (ROOT / "gappadder").is_dir():
        raise PhaseError(f"{ROOT} holds no gappadder package: run this "
                         "script from a checkout of the repository")
    for p in (ROOT, ROOT / "scripts", ROOT / "tests"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


class CompileMeter:
    """Sums XLA backend compile time through jax.monitoring."""

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def __call__(self, event: str, duration: float, **_kw) -> None:
        if event == BACKEND_COMPILE_EVENT:
            self.seconds += duration
            self.count += 1

    def snapshot(self) -> tuple[float, int]:
        return self.seconds, self.count


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def nvidia_smi() -> list[str]:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]


def device_phase(want_count: int) -> dict:
    import jax
    from gappadder.io import native
    from gappadder.utils.jaxcache import setup_compile_cache

    devs = jax.devices()
    d0 = devs[0]
    check(d0.platform == "gpu",
          f"JAX platform is {d0.platform!r}, not 'gpu': no accelerator")
    check(len(devs) >= want_count,
          f"need {want_count} GPUs, JAX sees {len(devs)}")
    cards = nvidia_smi()
    print(f"device: {d0.device_kind} x{len(devs)} ({d0.platform})")
    for c in cards[:max(want_count, 1)]:
        print(f"card: {c}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {setup_compile_cache()}")
    reason = native.failure_reason()
    print("native BAM decoder: " + ("loaded" if reason is None
                                    else f"NOT loaded ({reason})"))
    stats = d0.memory_stats() or {}
    print(f"device memory limit: {stats.get('bytes_limit', 'n/a')} bytes")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs), "card": cards[0]}


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

KERNEL_CASES = (
    # name, pairs, Lq, Lt, mode, end_slack, params
    ("pick_lt1024", 1024, 300, 1024, "local", 0, "bwa"),
    ("pick_lt2048", 1024, 300, 2048, "local", 0, "bwa"),
    ("contig_overlap", 512, 1024, 1024, "overlap", 50, "merge"),
    ("contig_fit", 512, 1024, 1024, "fit", 0, "merge"),
    ("contig_extend", 512, 1024, 1024, "extend", 0, "merge"),
)


def kernel_phase(card: str, seed: int = 0, host_sample: int = 64) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from gappadder.ops import merge_engine, sw_host, sw_xla
    from gappadder.utils.meters import time_blocked
    from swbench import random_pairs

    params_of = {"bwa": sw_host.BWA_PARAMS,
                 "merge": merge_engine.MERGE_PARAMS}
    rng = np.random.default_rng(seed)
    out = {}
    for name, B, Lq, Lt, mode, slack, pname in KERNEL_CASES:
        p = params_of[pname]
        q, ql, t, tl = random_pairs(rng, B, Lq, Lt)
        args = tuple(jnp.asarray(a) for a in (q, ql, t, tl))

        def run():
            return sw_xla.sw_batch(*args, p, mode, end_slack=slack)

        got = [np.asarray(x) for x in run()]
        for b in rng.choice(B, size=min(host_sample, B), replace=False):
            score, _, _, H = sw_host.sw_np(q[b, :ql[b]], t[b, :tl[b]], p,
                                           mode, end_slack=slack)
            check(int(got[0][b]) == int(score),
                  f"kernel {name}: pair {b} score {got[0][b]} != host "
                  f"oracle {score}")
            check(int(H[got[1][b], got[2][b]]) == int(score),
                  f"kernel {name}: pair {b} end ({got[1][b]}, "
                  f"{got[2][b]}) does not reach the host score {score}")
        t_xla = time_blocked(run)
        ma = sw_xla.sw_batch.lower(*args, p, mode,
                                   end_slack=slack).compile().memory_analysis()
        cells = float(np.sum(ql.astype(np.int64) * tl))
        print(f"kernel {name}: B={B} Lq={Lq} Lt={Lt} mode={mode} "
              f"slack={slack}: sw_xla agrees with the host oracle on "
              f"{min(host_sample, B)} pairs; {t_xla * 1e3:.3f} ms "
              f"({cells / t_xla / 1e9:.1f} GCUPS) [{card}]")
        print(f"  memory_analysis: args {ma.argument_size_in_bytes} B, out "
              f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")
        out[name] = t_xla
    return out


def sort_observations(card: str) -> None:
    """How XLA:GPU lowers the pipeline's variadic multi-limb sorts, and
    what they cost to compile and run (k-mer merge shape: 64 gaps x
    16k slots; 1, 2 and 4 uint32 limbs + one int32 count)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gappadder.utils.meters import time_blocked

    rng = np.random.default_rng(1)
    G, P = 64, 1 << 14
    for nl in (1, 2, 4):
        ops = tuple(jnp.asarray(rng.integers(0, 1 << 32, (G, P),
                                             dtype=np.uint32))
                    for _ in range(nl)) + (
            jnp.asarray(rng.integers(0, 9, (G, P), dtype=np.int32)),)
        fn = jax.jit(lambda *o, nl=nl: jax.lax.sort(o, dimension=1,
                                                    num_keys=nl))
        t0 = time.perf_counter()
        compiled = fn.lower(*ops).compile()
        t_comp = time.perf_counter() - t0
        text = compiled.as_text()
        how = ("cub radix sort" if "DeviceRadixSort" in text
               else "XLA sort kernel")
        t_run = time_blocked(lambda: compiled(*ops))
        print(f"sort {nl}-limb + payload [{G}, {P}]: {how}; compile "
              f"{t_comp:.2f} s, run {t_run * 1e3:.3f} ms [{card}]")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def simulate(workdir: pathlib.Path, n_gaps: int, scaf_kb: int, seed: int):
    """Draft (n_gaps // 8 scaffolds of scaf_kb kb, 8 gaps each), truth,
    BAM and FASTQ pair, from the repository's generator."""
    import numpy as np
    import stress_pipeline
    workdir.mkdir(parents=True, exist_ok=True)
    stress_pipeline.simulate(workdir, n_gaps, scaf_kb,
                             np.random.default_rng(seed))


def write_config(workdir: pathlib.Path, out: str, kset, flank: int,
                 mesh: int) -> str:
    by_k: dict[int, list[int]] = {}
    for k, sub in kset:
        by_k.setdefault(k, []).append(sub)
    cfg = {
        "draft_genome": {"fa": "draft.fa"},
        "raw_reads": [{"left": "l.fq", "right": "r.fq"}],
        "alignments": [{"bam": "lib.bam", "is": 300, "std": 30}],
        "kmer_length": [{"k": k, "k_velvet": [{"k": s} for s in subs]}
                        for k, subs in by_k.items()],
        "parameters": {"working_folder": out, "min_gap_size": 100,
                       "flank_length": flank},
        "device": {"mesh_shape": [mesh]},
    }
    path = workdir / f"{out}.json"
    path.write_text(json.dumps(cfg, indent=1))
    return str(path)


def run_cli(argv) -> None:
    from gappadder import cli
    rc = cli.main(list(argv))
    check(rc == 0, f"gappadder {' '.join(argv)} exited {rc}")


def score_fills(workdir: pathlib.Path, out: str) -> dict:
    """Picked full closures against the planted truth."""
    from gappadder import cli, dna
    from gappadder.config import load_config
    from gappadder.io import fasta
    from gappadder.pipeline.workspace import Workspace

    cfg = load_config(str(workdir / f"{out}.json"))
    ws = Workspace(cfg.workdir)
    gaps = ws.load_arrays("gaps")
    truth = fasta.read_fasta(str(workdir / "truth.fa"))
    fills = cli._fills_from_picked(ws, gaps)
    m = cfg.flank_margin
    wrong = []
    for g, seq in fills.items():
        t = truth.scaffold(int(gaps["scaffold"][g]))
        want = t[int(gaps["local_start"][g]) - m:
                 int(gaps["local_end"][g]) + m]
        if dna.decode(seq) != dna.decode(want):
            wrong.append(g)
    return {"gaps": len(gaps["start"]), "closed": len(fills),
            "wrong": len(wrong), "wrong_ids": wrong[:10],
            "metrics": json.loads(pathlib.Path(
                ws.path("metrics.json")).read_text())}


def main_path(workdir: pathlib.Path, n_gaps: int, scaf_kb: int, kset,
              flank: int, seed: int = 0, mesh: int = 1, out: str = "work",
              simulate_data: bool = True) -> dict:
    """Generate the deployment (unless already there), run -c All, and
    check the fills. Returns the counts and metrics; raises PhaseError
    when a fill differs from the truth or fewer than 95% close."""
    if simulate_data:
        t0 = time.perf_counter()
        simulate(workdir, n_gaps, scaf_kb, seed)
        print(f"main: simulated {n_gaps} gaps on {n_gaps // 8} x "
              f"{scaf_kb} kb scaffolds in {time.perf_counter() - t0:.1f} s")
    cfg = write_config(workdir, out, kset, flank, mesh)
    t0 = time.perf_counter()
    run_cli(["-c", "All", "-g", cfg])
    wall = time.perf_counter() - t0
    res = score_fills(workdir, out)
    res["wall_s"] = wall
    check(res["wrong"] == 0,
          f"{res['wrong']} picked fills differ from the planted truth "
          f"(gaps {res['wrong_ids']})")
    check(res["closed"] >= 0.95 * res["gaps"],
          f"only {res['closed']}/{res['gaps']} gaps closed (< 95%)")
    return res


def _stage_line(metrics: dict) -> str:
    return ", ".join(f"{k} {v['seconds']:.2f} s"
                     for k, v in metrics["stages"].items())


def main_phase(card: str, workdir: pathlib.Path, n_gaps: int, scaf_kb: int,
               kset, meter: CompileMeter) -> dict:
    import jax
    c0, n0 = meter.snapshot()
    res = main_path(workdir, n_gaps, scaf_kb, kset, 300)
    c1, n1 = meter.snapshot()
    print(f"main: -c All on {res['gaps']} gaps, {len(kset)} (k, sub_k), "
          f"300 bp flanks: {res['closed']} closed, {res['wrong']} differ "
          f"from truth, {res['wall_s']:.2f} s wall [{card}]")
    print(f"main: stages {_stage_line(res['metrics'])} [{card}]")
    print(f"main: compile {c1 - c0:.2f} s in {n1 - n0} XLA compilations "
          f"(cold unless the cache dir was warm) [{card}]")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"main: peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          f"[{card}]")
    return res


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def four_phase(card: str, workdir: pathlib.Path, n_gaps: int, scaf_kb: int,
               n: int = 4, kset=KSET6, flank: int = 300) -> None:
    """-c All with mesh_shape [n] (gap-home routing over all_to_all,
    parallel/dist.py) and with one device; the outputs must be
    byte-equal."""
    outs = {}
    for mesh in (n, 1):
        out = f"work_mesh{mesh}"
        res = main_path(workdir, n_gaps, scaf_kb, kset, flank, mesh=mesh,
                        out=out, simulate_data=(mesh == n))
        print(f"four: mesh [{mesh}]: {res['closed']}/{res['gaps']} closed, "
              f"{res['wrong']} wrong, {res['wall_s']:.2f} s wall, stages "
              f"{_stage_line(res['metrics'])} [{card}]")
        outs[mesh] = workdir / out
    for fname in ("picked_seqs.fa", "picked_seqs.fa_ori.txt",
                  "merge_info.txt"):
        a = (outs[n] / fname).read_bytes()
        b = (outs[1] / fname).read_bytes()
        check(a == b, f"{fname} differs between mesh [{n}] and [1]")
        print(f"four: {fname} byte-equal ({len(a)} bytes)")


# ---------------------------------------------------------------------------

def parse_ksets(text: str) -> tuple[tuple[int, int], ...]:
    return tuple((int(k), int(sub)) for k, sub in
                 (item.split(":") for item in text.split(",")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--gaps", type=int, default=400,
                    help="planted gaps, 8 per scaffold (default 400)")
    ap.add_argument("--scaffold-kb", type=int, default=100)
    ap.add_argument("--ksets", type=parse_ksets, default=KSET6,
                    help="(k, sub_k) settings as k:sub,k:sub,... "
                    "(default: the reference's six)")
    args = ap.parse_args(argv)

    try:
        _import_paths()
        import jax
        meter = CompileMeter()
        jax.monitoring.register_event_duration_secs_listener(meter)
        n = 4 if args.four_cards else 1
        dev = device_phase(n)
        with tempfile.TemporaryDirectory(prefix="gappadder_smoke_") as tmp:
            workdir = pathlib.Path(tmp)
            if args.four_cards:
                four_phase(dev["card"], workdir, args.gaps,
                           args.scaffold_kb, n, args.ksets)
            else:
                kernel_phase(dev["card"])
                sort_observations(dev["card"])
                main_phase(dev["card"], workdir, args.gaps,
                           args.scaffold_kb, args.ksets, meter)
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
