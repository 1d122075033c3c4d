"""Device benchmark: the SW kernel and the fused pipeline slice.

    python bench.py [--gaps 64]

Needs a GPU and fails without one. Runs in one process:

  sw           the SW kernel (sw_xla) at 512 x 128 x 1024 local
               (scripts/swbench.py);
  slice        the fused collect->assemble->pick slice
               (parallel/slice.py) at the toy shape, --gaps per step;
  production   the same slice at the reference shape: six (k, sub_k)
               30/40/50, 300 bp flanks, 100 bp reads, skewed
               100-1000 bp gaps, 16 gaps per step.

Every time is the median of warmed calls waited for with
block_until_ready; the first call (compile included) is reported as
set-up. The last line of output is one JSON object:
  {"metric": "e2e_gaps_per_s", "value": ..., "unit": ..., "device": ...}
"""

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaps", type=int, default=64)
    args = ap.parse_args()

    import jax
    from gappadder.utils.jaxcache import setup_compile_cache

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX platform is {d.platform}")
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}", flush=True)
    setup_compile_cache()

    import slice_bench
    import swbench

    sw = swbench.measure(512, 128, 1024, "local")
    print(json.dumps({"sw": sw}), flush=True)
    toy = slice_bench.measure(1, gaps_per_shard=args.gaps)
    print(json.dumps({"slice": toy}), flush=True)
    prod = slice_bench.measure(1, gaps_per_shard=16, production=True)
    print(json.dumps({"slice_production": prod}), flush=True)

    print(json.dumps({
        "metric": "e2e_gaps_per_s",
        "value": toy["gaps_per_s"],
        "unit": (f"gaps/s, fused collect+assemble+pick slice "
                 f"({toy['n_gaps_per_step']} gaps x "
                 f"{toy['n_records_per_step']} records per step)"),
        "device": device,
        "e2e_production_gaps_per_s": prod["gaps_per_s"],
        "sw_xla_gcups": sw["xla_gcups"],
    }))


if __name__ == "__main__":
    main()
