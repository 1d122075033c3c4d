"""Fused sharded pipeline slice: correctness + mesh-shape invariance.

The slice (parallel/slice.py) is the production collect->assemble
dataplane under real shardings: records sharded dp, recruits routed to
gap-home shards, per-gap assembly local. Because every gap's read set
lands wholly on its home shard, results must be independent of the
mesh shape — the property these tests assert (1/2/4/8 shards equal),
mirroring the reference's one-process-per-gap dispatch
(/root/reference/assemble_gaps.py:296-318) which is trivially
mesh-independent.
"""

import numpy as np
import pytest

import jax

from gappadder import dna
from gappadder.parallel import slice as sl
from gappadder.parallel.mesh import make_mesh


def run_slice(n_shards: int, gaps_per_shard: int, gap_len=64):
    mesh = make_mesh(shape=(n_shards,), axes=("dp",),
                     devices=jax.devices()[:n_shards])
    dims, args = sl.example_data(n_shards, gaps_per_shard=gaps_per_shard,
                                 gap_len=gap_len)
    step = sl.make_slice_step(mesh, dims)
    out = step(*sl.place_args(mesh, args))
    (counts, hist, n_recv, n_reads, rowtab, hqtab, useq, ulen, ucnt,
     scores, qend, tend) = (np.asarray(o) for o in out)
    G = dims.n_gaps
    Gl = dims.gaps_per_shard
    per_gap = {}
    for shard in range(n_shards):
        for slot in range(Gl):
            g = shard + slot * n_shards           # home_of inverse
            i = shard * Gl + slot                 # row in global outputs
            contigs = []
            for u in range(useq.shape[1]):
                L = int(ulen[i, u])
                if L > 0:
                    s = dna.decode(useq[i, u, :L])
                    contigs.append(min(s, dna.decode(
                        dna.revcomp(useq[i, u, :L]))))
            per_gap[g] = dict(n_reads=int(n_reads[i]),
                              contigs=sorted(contigs),
                              # best flank score over strands+contigs
                              score=(int(scores[i, 0:2].max()),
                                     int(scores[i, 2:4].max())))
    assert set(per_gap) == set(range(G))
    return dict(counts=counts.tolist(), hist=hist.tolist(),
                total_recv=int(n_recv.sum()), per_gap=per_gap)


def test_slice_closes_planted_gaps():
    res = run_slice(8, 2)
    # every planted gap: reads recruited, a unitig spanning the gap
    # region (gap 64bp + 2x40bp margins - 1 overlap artifacts), and the
    # flanks matching at the max possible local score (margin = 40).
    for g, r in res["per_gap"].items():
        assert r["n_reads"] == 25, g
        assert max(len(c) for c in r["contigs"]) >= 128, g
        assert r["score"] == (40, 40), g
    assert res["counts"][0] == 400  # all planted reads classified clip


def test_slice_closes_skewed_gaps():
    """Skewed (log-uniform 64..160) per-gap lengths in ONE batch: the
    bucket/caps machinery must still close every gap — contigs span
    each gap's own length and both flanks hit at the max local score.
    Mirrors the realistic many-short/long-tail draft distribution the
    uniform scenario doesn't exercise."""
    res = run_slice(4, 2, gap_len=(64, 160))
    # replicate example_data's deterministic per-gap draw (seed 0,
    # lengths drawn before any other rng use)
    rng = np.random.default_rng(0)
    glens = np.exp(rng.uniform(np.log(64), np.log(160), 8))
    glens = np.clip(np.round(glens).astype(np.int32), 64, 160)
    margin = 40                       # read_len 48 - 8
    for g, r in res["per_gap"].items():
        # left tiling grid starts exactly at gs-margin -> full score;
        # the right margin loses up to step-1 bases when glen % step != 0
        assert r["score"][0] == 40, g
        assert r["score"][1] >= 40 - 3, g
        assert max(len(c) for c in r["contigs"]) >= \
            int(glens[g]) + 2 * margin - 8, g


@pytest.mark.parametrize("n_shards,gaps_per_shard",
                         [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_slice_mesh_shape_invariance(n_shards, gaps_per_shard):
    """Same 8-gap scenario on every mesh shape -> identical per-gap
    contigs/scores and identical global psum outputs."""
    base = run_slice(8, 1)
    got = run_slice(n_shards, gaps_per_shard)
    # counts[7] is the pmax per-shard router demand — legitimately
    # mesh-shape-dependent (fewer shards receive more rows each);
    # everything else must be invariant.
    assert got["counts"][:7] == base["counts"][:7]
    assert got["counts"][7] * n_shards >= base["counts"][7]
    assert got["hist"] == base["hist"]
    assert got["total_recv"] == base["total_recv"]
    for g in base["per_gap"]:
        assert got["per_gap"][g] == base["per_gap"][g], g
