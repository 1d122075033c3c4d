"""Router parity: dense all-to-all routing vs a host oracle.

The gap-home router (parallel/dist.py) must deliver every valid row to
its destination shard in source-major order (stable within a source) —
the property that makes downstream per-gap dedup/assembly independent
of the mesh shape. Oracle: plain numpy permutation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gappadder.parallel import dist
from gappadder.parallel.mesh import make_mesh


def host_route(payloads, dest, valid, n_shards):
    """Source-major oracle. Returns per-shard lists of row tuples."""
    out = [[] for _ in range(n_shards)]
    src = [[] for _ in range(n_shards)]
    cap = dest.shape[1]
    for s in range(n_shards):
        for j in range(cap):
            if valid[s, j]:
                d = int(dest[s, j])
                out[d].append(tuple(p[s, j] for p in payloads))
                src[d].append(s)
    return out, src


@pytest.mark.parametrize("mesh_axes", [("dp",), ("dp", "sp")])
def test_route_matches_oracle(rng, mesh_axes):
    devs = jax.devices()[:8]
    if len(mesh_axes) == 1:
        mesh = make_mesh(shape=(8,), axes=mesh_axes, devices=devs)
    else:
        mesh = make_mesh(shape=(4, 2), axes=mesh_axes, devices=devs)
    N = 8
    cap, out_cap, L = 16, 64, 5

    dest = rng.integers(0, N, (N, cap)).astype(np.int32)
    valid = rng.random((N, cap)) < 0.7
    pay1 = rng.integers(0, 1 << 30, (N, cap)).astype(np.int32)
    pay2 = rng.integers(0, 4, (N, cap, L)).astype(np.int8)

    router = dist.make_router(mesh, n_payloads=2, out_cap=out_cap)
    (r1, r2), src, n_recv = router(
        (dist.place_dp(mesh, pay1.reshape(-1)),
         dist.place_dp(mesh, pay2.reshape(N * cap, L))),
        dist.place_dp(mesh, dest.reshape(-1)),
        dist.place_dp(mesh, valid.reshape(-1)))
    r1 = np.asarray(r1).reshape(N, out_cap)
    r2 = np.asarray(r2).reshape(N, out_cap, L)
    src = np.asarray(src).reshape(N, out_cap)
    n_recv = np.asarray(n_recv).reshape(N)

    want, want_src = host_route((pay1, pay2), dest, valid, N)
    assert n_recv.sum() == valid.sum()
    for d in range(N):
        assert n_recv[d] == len(want[d])
        for j, (w1, w2) in enumerate(want[d]):
            assert r1[d, j] == w1
            assert (r2[d, j] == w2).all()
            assert src[d, j] == want_src[d][j]
        # padding rows are fill-valued
        assert (r1[d, n_recv[d]:] == -1).all()
        assert (src[d, n_recv[d]:] == -1).all()


def test_dense_route_empty_and_skewed(rng):
    """All rows to one shard; zero valid rows on some shards."""
    mesh = make_mesh(shape=(8,), axes=("dp",), devices=jax.devices()[:8])
    N, cap, out_cap = 8, 8, 64
    dest = np.full((N, cap), 3, np.int32)
    valid = np.zeros((N, cap), bool)
    valid[1] = True       # only shard 1 sends; everything to shard 3
    pay = np.arange(N * cap, dtype=np.int32).reshape(N, cap)

    router = dist.make_router(mesh, n_payloads=1, out_cap=out_cap)
    (r,), src, n_recv = router((dist.place_dp(mesh, pay.reshape(-1)),),
                               dist.place_dp(mesh, dest.reshape(-1)),
                               dist.place_dp(mesh, valid.reshape(-1)))
    r = np.asarray(r).reshape(N, out_cap)
    n_recv = np.asarray(n_recv).reshape(N)
    assert n_recv[3] == cap and n_recv[[0, 1, 2, 4, 5, 6, 7]].sum() == 0
    assert (r[3, :cap] == pay[1]).all()


def test_send_tables():
    dest = jnp.asarray(np.array([2, 0, 2, 1, 0], np.int32))
    valid = jnp.asarray(np.array([1, 1, 1, 1, 0], bool))
    order, key_s, send, in_off = dist.send_tables(dest, valid, 3)
    assert np.asarray(send).tolist() == [1, 1, 2]
    assert np.asarray(in_off).tolist() == [0, 1, 2]
    assert np.asarray(key_s).tolist() == [0, 1, 2, 2, 3]
    assert np.asarray(order).tolist() == [1, 3, 0, 2, 4]


def test_route_overflow_drops_highest_ranks(rng):
    """out_cap smaller than demand: rows are dropped deterministically
    from the HIGHEST source ranks, delivered rows stay intact, and
    n_recv reports the RAW demand so the caller can detect the loss."""
    mesh = make_mesh(shape=(4,), axes=("dp",), devices=jax.devices()[:4])
    N, cap, out_cap = 4, 8, 12      # demand to shard 0 = 32 > 12
    dest = np.zeros((N, cap), np.int32)
    valid = np.ones((N, cap), bool)
    pay = (np.arange(N * cap, dtype=np.int32)).reshape(N, cap)

    router = dist.make_router(mesh, n_payloads=1, out_cap=out_cap)
    (r,), src, n_recv = router((dist.place_dp(mesh, pay.reshape(-1)),),
                               dist.place_dp(mesh, dest.reshape(-1)),
                               dist.place_dp(mesh, valid.reshape(-1)))
    r = np.asarray(r).reshape(N, out_cap)
    src = np.asarray(src).reshape(N, out_cap)
    n_recv = np.asarray(n_recv).reshape(N)
    assert n_recv[0] == N * cap                  # raw demand visible
    # delivered: rows in source-major order, truncated from the
    # highest source ranks (source i contributes its rows in order)
    want = pay.reshape(-1)[:out_cap]
    want_src = np.repeat(np.arange(N), cap)[:out_cap]
    assert (r[0] == want).all()
    assert (src[0] == want_src).all()
