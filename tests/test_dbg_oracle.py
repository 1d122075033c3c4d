"""Property test: the batched DBG assembler vs a brute-force oracle.

The oracle builds the same double-stranded de-Bruijn graph with plain
dicts and walks maximal unitigs; the device assembler must produce
exactly the same unitig set (canonical strands, min-length filtered,
tips untouched because the oracle applies the same rule).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gappadder import dna
from gappadder.ops import dbg


def _revcomp_s(s):
    return dna.decode(dna.revcomp(dna.encode(s)))


def _oracle_unitigs(kstrings, sub_k, min_len):
    """Brute-force: nodes = sub_k-mers, edges = (sub_k+1)-mers of the
    k-strings + revcomps; chains where outdeg(u)==indeg(v)==1; cycles
    broken at their minimum node; revcomp-twin dedup by lexicographic
    strand; tip clipping mirrored from the device rule."""
    seqs = list(kstrings) + [_revcomp_s(s) for s in kstrings]
    nodes = set()
    edges = set()
    for s in seqs:
        for i in range(len(s) - sub_k + 1):
            nodes.add(s[i:i + sub_k])
        for i in range(len(s) - sub_k):
            edges.add(s[i:i + sub_k + 1])
    out_e = {}
    in_e = {}
    for e in edges:
        u, v = e[:-1], e[1:]
        out_e.setdefault(u, set()).add(v)
        in_e.setdefault(v, set()).add(u)
    outdeg = {n: len(out_e.get(n, ())) for n in nodes}
    indeg = {n: len(in_e.get(n, ())) for n in nodes}

    def chain_succ(u):
        if outdeg.get(u, 0) == 1:
            v = next(iter(out_e[u]))
            if indeg.get(v, 0) == 1:
                return v
        return None

    def chain_pred(v):
        if indeg.get(v, 0) == 1:
            u = next(iter(in_e[v]))
            if outdeg.get(u, 0) == 1:
                return u
        return None

    # node ordering identical to the device (sorted sub_k-mer strings)
    order = {n: i for i, n in enumerate(sorted(nodes))}
    heads = set()
    for n in nodes:
        if chain_pred(n) is None:
            heads.add(n)
    # cycles: nodes not reachable from any head
    visited = set()
    for h in heads:
        u = h
        while u is not None and u not in visited:
            visited.add(u)
            u = chain_succ(u)
    cyc = sorted(set(nodes) - visited, key=lambda n: order[n])
    while cyc:
        h = cyc[0]  # min-id node of (some) cycle
        heads.add(h)
        u = h
        while u is not None and u not in visited:
            visited.add(u)
            u = chain_succ(u)
        cyc = sorted(set(nodes) - visited, key=lambda n: order[n])

    unitigs = []
    for h in sorted(heads, key=lambda n: order[n]):
        s = h
        seen = {h}
        u = chain_succ(h)
        while u is not None and u not in seen:
            s += u[-1]
            seen.add(u)
            u = chain_succ(u)
        unitigs.append(s)

    # tip clipping (device rule): short chain, dead at exactly one end,
    # with an alternative branch at the attached junction
    def is_tip(s):
        if len(s) >= 2 * (sub_k + 1):
            return False
        head, tail = s[:sub_k], s[-sub_k:]
        head_dead = indeg.get(head, 0) == 0
        tail_dead = outdeg.get(tail, 0) == 0
        if head_dead == tail_dead:
            return False
        if head_dead:
            return any(indeg.get(w, 0) >= 2 for w in out_e.get(tail, ()))
        return any(outdeg.get(u, 0) >= 2 for u in in_e.get(head, ()))

    out = set()
    for s in unitigs:
        if len(s) < min_len or is_tip(s):
            continue
        rc = _revcomp_s(s)
        out.add(min(s, rc))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k,sub_k", [(17, 11), (21, 15)])
@pytest.mark.parametrize("with_cycle", [False, True])
def test_dbg_matches_bruteforce(seed, k, sub_k, with_cycle):
    rng = np.random.default_rng(seed)
    # random sequences with shared chunks to create branches/cycles
    base = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 80)])
    seqs = [base,
            base[20:60] + "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)]),
            "".join(np.array(list("ACGT"))[rng.integers(0, 4, 50)])]
    if with_cycle:
        # a periodic repeat whose period exceeds sub_k forces a true
        # DBG cycle (regression: the packed doubling's hop field
        # overflowed on cycles and carried into the pointer bits)
        per = "".join(np.array(list("ACGT"))[rng.integers(0, 4,
                                                         sub_k + 2)])
        seqs.append((per * 5)[:3 * sub_k + 7])
    kstr = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            sub = s[i:i + k]
            kstr.add(min(sub, _revcomp_s(sub)))
    kstr = sorted(kstr)

    arr = np.full((1, len(kstr), k), dna.N, np.int8)
    for i, s in enumerate(kstr):
        arr[0, i] = dna.encode(s)
    useq, ulen, ucnt = dbg.assemble_unitigs(
        jnp.asarray(arr), jnp.asarray([len(kstr)], jnp.int32),
        k=k, sub_k=sub_k, max_unitigs=64, max_len=512, min_len=sub_k)
    got = set()
    for i in range(int(ucnt[0])):
        s = dna.decode(np.asarray(useq[0][i][:int(ulen[0][i])]))
        got.add(min(s, _revcomp_s(s)))

    want = _oracle_unitigs(kstr, sub_k, min_len=sub_k)
    assert got == want, (sorted(got - want), sorted(want - got))
