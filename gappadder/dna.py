"""DNA encoding primitives shared by host I/O and device kernels.

Bases are encoded as small integers so sequence data lives in dense
int8 device arrays:

    A=0  C=1  G=2  T=3  N(=any non-ACGT)=4  SEP=5 (scaffold separator)

The 2-bit code of A/C/G/T is chosen so that ``3 - code`` is the
complement (A<->T, C<->G), making reverse-complement a flip + reverse.

The reference keeps sequences as Python strings throughout
(e.g. /root/reference/gnrt_pos_true_seqs.py:15, ContigsMerger
fastareader.h:16-47); here everything is columnar numpy/JAX arrays.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N, SEP = 0, 1, 2, 3, 4, 5

# byte -> code lookup (case-insensitive; every non-ACGT byte maps to N)
_ENCODE_LUT = np.full(256, N, dtype=np.int8)
for _b, _c in ((b"Aa", A), (b"Cc", C), (b"Gg", G), (b"Tt", T)):
    _ENCODE_LUT[_b[0]] = _c
    _ENCODE_LUT[_b[1]] = _c

_DECODE_LUT = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()

# complement of codes 0..5 (N and SEP are their own complement)
COMPLEMENT = np.array([T, G, C, A, N, SEP], dtype=np.int8)


def encode(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII sequence to int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """Decode int8 codes back to an ASCII string."""
    codes = np.asarray(codes)
    return _DECODE_LUT[np.clip(codes, 0, 5)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of an int8 code array (numpy, host side)."""
    return COMPLEMENT[np.asarray(codes)[::-1]]


def revcomp_jnp(codes, length=None):
    """Reverse-complement for device arrays.

    If ``length`` is given the array is treated as padded to its full
    size with garbage after ``length`` valid codes; the valid prefix is
    reversed in place and the padding region is filled with N.
    """
    import jax.numpy as jnp

    # arithmetic complement (A<->T is 0<->3, C<->G is 1<->2, N/SEP
    # fixed): elementwise, no table gather
    codes = jnp.asarray(codes)
    comp = jnp.where(codes < 4, (3 - codes).astype(codes.dtype), codes)
    if length is None:
        return comp[..., ::-1]
    n = codes.shape[-1]
    idx = jnp.asarray(length)[..., None] - 1 - jnp.arange(n)  # [..., n]
    ok = idx >= 0
    idx = jnp.broadcast_to(jnp.where(ok, idx, 0), comp.shape)
    return jnp.where(ok, jnp.take_along_axis(comp, idx, axis=-1), N)
