import numpy as np
import jax.numpy as jnp

from gappadder import dna
from gappadder.ops import seedmatch


def _contigs(rng, n, L):
    seqs = rng.integers(0, 4, (n, L)).astype(np.int8)
    lens = np.full(n, L, np.int32)
    return seqs, lens


def test_match_finds_origin(rng):
    K = 19
    contigs, clens = _contigs(rng, 6, 400)
    # reads sampled from contigs (fwd and rc)
    reads = np.full((12, 100), dna.N, np.int8)
    rlens = np.full(12, 100, np.int32)
    origin = []
    for i in range(12):
        c = int(rng.integers(0, 6))
        p = int(rng.integers(0, 300))
        frag = contigs[c, p:p + 100]
        if i % 2:
            frag = dna.revcomp(frag)
        reads[i, :100] = frag
        origin.append((i, i % 2, c))
    idx = seedmatch.build_index(contigs, clens, K)
    votes = seedmatch.match_candidates(jnp.asarray(reads),
                                       jnp.asarray(rlens),
                                       idx["limbs"], idx["contig"], k=K)
    pairs = seedmatch.vote_pairs(votes, min_votes=2)
    found = {(r, s, c) for r, s, c, _v in pairs}
    for (r, s, c) in origin:
        assert (r, s, c) in found, (r, s, c)


def test_no_spurious_matches(rng):
    K = 19
    contigs, clens = _contigs(rng, 4, 300)
    reads = rng.integers(0, 4, (8, 80)).astype(np.int8)  # unrelated
    rlens = np.full(8, 80, np.int32)
    idx = seedmatch.build_index(contigs, clens, K)
    votes = seedmatch.match_candidates(jnp.asarray(reads),
                                       jnp.asarray(rlens),
                                       idx["limbs"], idx["contig"], k=K)
    pairs = seedmatch.vote_pairs(votes, min_votes=2)
    assert pairs == []
