"""FASTA reader equivalence: chunked vectorized parser vs line parser."""

import numpy as np
import pytest

from gappadder import dna
from gappadder.io import fasta


def _random_fasta(rng, path, n_rec=5, crlf=False, lowercase=False,
                  widths=(7, 80, 200), with_n=True, empty_lines=True,
                  no_final_newline=False):
    eol = "\r\n" if crlf else "\n"
    truths = []
    lines = []
    alpha = "acgtn" if lowercase else "ACGTN"
    for r in range(n_rec):
        L = int(rng.integers(0, 500))
        probs = [0.24, 0.24, 0.24, 0.24, 0.04] if with_n else \
            [0.25, 0.25, 0.25, 0.25, 0.0]
        s = "".join(np.array(list(alpha))[
            rng.choice(5, L, p=probs)])
        truths.append(s.upper().replace("N", "N"))
        lines.append(f">rec{r} some description{eol}")
        w = int(rng.choice(widths))
        for i in range(0, L, w):
            lines.append(s[i:i + w] + eol)
        if empty_lines and rng.integers(0, 2):
            lines.append(eol)
    text = "".join(lines)
    if no_final_newline:
        text = text.rstrip("\r\n")
    with open(path, "w", newline="") as fh:
        fh.write(text)
    return truths


@pytest.mark.parametrize("crlf,lowercase,nofinal", [
    (False, False, False), (True, False, False),
    (False, True, True), (True, True, False)])
def test_chunked_matches_line_parser(tmp_path, rng, crlf, lowercase,
                                     nofinal):
    path = str(tmp_path / "g.fa")
    _random_fasta(rng, path, n_rec=6, crlf=crlf, lowercase=lowercase,
                  no_final_newline=nofinal)
    b = fasta.read_fasta_chunked(path)
    # the plain line-parser path (force small-file route)
    import gappadder.io.fasta as fmod
    old = fmod._BIG_FASTA_BYTES
    try:
        fmod._BIG_FASTA_BYTES = 1 << 60
        a = fasta.read_fasta(path)
    finally:
        fmod._BIG_FASTA_BYTES = old
    assert a.names == b.names
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.seq, b.seq)


def test_chunk_boundaries_exact(tmp_path, rng):
    """Tiny chunk sizes force record/line splits across every boundary."""
    path = str(tmp_path / "g.fa")
    _random_fasta(rng, path, n_rec=8)
    import gappadder.io.fasta as fmod
    old = fmod._BIG_FASTA_BYTES
    try:
        fmod._BIG_FASTA_BYTES = 1 << 60
        want = fasta.read_fasta(path)
    finally:
        fmod._BIG_FASTA_BYTES = old
    for cb in (17, 64, 257, 4096):
        got = fasta.read_fasta_chunked(path, chunk_bytes=cb)
        assert got.names == want.names, cb
        np.testing.assert_array_equal(got.seq, want.seq, str(cb))
        np.testing.assert_array_equal(got.lengths, want.lengths, str(cb))


def test_size_gate_routes_big_files(tmp_path, rng, monkeypatch):
    import gappadder.io.fasta as fmod
    path = str(tmp_path / "g.fa")
    _random_fasta(rng, path, n_rec=3)
    called = {}
    real = fmod.read_fasta_chunked

    def spy(p, **kw):
        called["yes"] = True
        return real(p, **kw)

    monkeypatch.setattr(fmod, "read_fasta_chunked", spy)
    monkeypatch.setattr(fmod, "_BIG_FASTA_BYTES", 1)
    g = fasta.read_fasta(path)
    assert called.get("yes") and g.num_scaffolds == 3


def test_empty_record_and_empty_file(tmp_path):
    p1 = str(tmp_path / "e.fa")
    with open(p1, "w") as fh:
        fh.write(">a\nACGT\n>empty\n>b\nGG\n")
    g = fasta.read_fasta_chunked(p1)
    assert g.names == ["a", "empty", "b"]
    assert list(g.lengths) == [4, 0, 2]
    assert dna.decode(g.scaffold(0)) == "ACGT"
    assert dna.decode(g.scaffold(2)) == "GG"
    p2 = str(tmp_path / "z.fa")
    open(p2, "w").close()
    g2 = fasta.read_fasta_chunked(p2)
    assert g2.num_scaffolds == 0
