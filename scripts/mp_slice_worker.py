"""Multi-process worker: run the fused sharded pipeline slice under
jax.distributed (gloo CPU collectives) and dump per-gap results.

Usage: python scripts/mp_slice_worker.py PROC_ID NPROC LOCAL_DEVS PORT OUT

Each process owns LOCAL_DEVS virtual CPU devices; the global mesh has
NPROC*LOCAL_DEVS shards. Process 0 writes a JSON summary that the
launcher (tests/test_multiprocess.py) compares bit-for-bit against a
single-process run of the same scenario — the multi-host equivalence
proof the reference never needed (it is single-node:
/root/reference/run_multi_threads_discordant.py:135-138).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, local_devs, port = (int(a) for a in sys.argv[1:5])
out_path = sys.argv[5]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", local_devs)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)

import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from gappadder import dna  # noqa: E402
from gappadder.parallel import slice as sl  # noqa: E402
from gappadder.parallel.mesh import make_mesh  # noqa: E402

n_shards = nproc * local_devs
assert len(jax.devices()) == n_shards, (pid, jax.devices())

mesh = make_mesh(shape=(n_shards,), axes=("dp",), devices=jax.devices())
dims, args = sl.example_data(n_shards, gaps_per_shard=1)
step = sl.make_slice_step(mesh, dims)
out = step(*sl.place_args_global(mesh, args))
res = multihost_utils.process_allgather(out, tiled=True)
(counts, hist, n_recv, n_reads, rowtab, hqtab, useq, ulen, ucnt,
 scores, qend, tend) = (np.asarray(r) for r in res)

if pid == 0:
    G, Gl = dims.n_gaps, dims.gaps_per_shard
    per_gap = {}
    for shard in range(n_shards):
        for slot in range(Gl):
            g = shard + slot * n_shards
            i = shard * Gl + slot
            contigs = []
            for u in range(useq.shape[1]):
                L = int(ulen[i, u])
                if L > 0:
                    s = dna.decode(useq[i, u, :L])
                    contigs.append(min(s, dna.decode(
                        dna.revcomp(useq[i, u, :L]))))
            per_gap[str(g)] = dict(
                n_reads=int(n_reads[i]), contigs=sorted(contigs),
                score=[int(scores[i, 0:2].max()),
                       int(scores[i, 2:4].max())])
    with open(out_path, "w") as f:
        json.dump(dict(counts=counts.tolist(), hist=hist.tolist(),
                       total_recv=int(n_recv.sum()),
                       per_gap=per_gap), f)
print(f"proc {pid} done", flush=True)
