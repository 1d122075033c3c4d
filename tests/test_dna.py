import numpy as np
import jax.numpy as jnp

from gappadder import dna


def test_encode_decode_roundtrip():
    s = "ACGTNacgtnRYK"
    codes = dna.encode(s)
    assert dna.decode(codes) == "ACGTNACGTNNNN"


def test_encode_values():
    assert list(dna.encode("ACGT")) == [0, 1, 2, 3]
    assert dna.encode("N")[0] == dna.N
    assert dna.encode("X")[0] == dna.N


def test_revcomp():
    assert dna.decode(dna.revcomp(dna.encode("ACGTN"))) == "NACGT"
    assert dna.decode(dna.revcomp(dna.encode("AAAC"))) == "GTTT"


def test_revcomp_jnp_matches_numpy(rng):
    codes = rng.integers(0, 5, size=64).astype(np.int8)
    out = np.asarray(dna.revcomp_jnp(jnp.asarray(codes)))
    np.testing.assert_array_equal(out, dna.revcomp(codes))


def test_revcomp_jnp_padded():
    codes = np.full(16, dna.N, np.int8)
    codes[:4] = dna.encode("ACGT")
    out = np.asarray(dna.revcomp_jnp(jnp.asarray(codes), length=4))
    assert dna.decode(out[:4]) == "ACGT"  # revcomp of ACGT is ACGT
    codes[:4] = dna.encode("AACG")
    out = np.asarray(dna.revcomp_jnp(jnp.asarray(codes), length=4))
    assert dna.decode(out[:4]) == "CGTT"
    assert (out[4:] == dna.N).all()
