"""Real-data smoke tests on the reference repo's binary fixtures
(/root/reference/TERefiner/test_code/ — real HG01890 BAMs vs the
humrep repeat library). VERDICT r1 #8: nothing had ever decoded
realistic BAM output (libbamtools-era files with 1000+ references,
multi-op CIGARs, every flag combination in the wild)."""

import os

import numpy as np
import pytest

from gappadder.io import bam as bam_io, native
from gappadder.ops import coverage as cov_ops
from gappadder.tools import refiner

FIXDIR = "/root/reference/TERefiner/test_code"
BAMS = [
    os.path.join(FIXDIR, "HG01890_keep_used.sort.bam"),
    os.path.join(FIXDIR, "HG01890_remove_used_has_upper_bound_keep_all"
                         "_20_0.2.fa.no_dup.fa.merged.fa.sort.bam"),
]

pytestmark = pytest.mark.skipif(
    not all(os.path.exists(p) for p in BAMS),
    reason="reference fixtures not mounted")


def _fai_lengths():
    lens = {}
    with open(os.path.join(FIXDIR, "humrep.ref.fai")) as fh:
        for line in fh:
            parts = line.split()
            lens[parts[0]] = int(parts[1])
    return lens


@pytest.mark.parametrize("path", BAMS, ids=["keep", "remove"])
def test_native_reader_matches_python_on_real_bam(path):
    a = bam_io.read_bam(path)
    b = native.read_bam_native(path)
    if b is None:
        pytest.skip("native library unavailable")
    assert a.refs == b.refs
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
              "lclip", "rclip", "nmatch", "read_len"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.name_hash, b.name_hash)
    assert a.n > 500


@pytest.mark.parametrize("path", BAMS, ids=["keep", "remove"])
def test_real_bam_against_fai_and_coverage_modes(path):
    """Decoded columns are consistent with the humrep.ref .fai, and the
    -B/-G coverage modes run with sane outputs on real data."""
    aln = bam_io.read_bam(path, keep_cigars=True)
    fai = _fai_lengths()
    assert len(aln.refs) == len(fai)
    lens = np.array([fai[r] for r in aln.refs], np.int64)

    mapped = (aln.flag & 4) == 0
    tid = aln.tid[mapped]
    assert (tid >= 0).all() and (tid < len(lens)).all()
    # mapped reads start inside their reference
    assert (aln.pos[mapped] >= 0).all()
    assert (aln.pos[mapped] < lens[tid]).all()
    # aligned columns never exceed read length (real BAMs carry SEQ-"*"
    # secondary records with l_seq 0 but full CIGARs — exclude those)
    has_seq = aln.read_len > 0
    assert (aln.nmatch[has_seq] <= aln.read_len[has_seq]).all()

    # exact (-B) pileup from real multi-op CIGARs
    mean_ex, cov_ex = cov_ops.per_base_coverage(
        aln.tid, aln.pos, aln.nmatch, lens,
        cigars=(aln.cig_op, aln.cig_ln, aln.cig_off))
    assert (cov_ex <= lens).all()
    assert (mean_ex >= 0).all() and cov_ex.sum() > 0
    # exact-segment invariant: each record's M-segment lengths sum to
    # its columnar nmatch (the approximation collapses exactly this)
    rec, s, e = cov_ops.m_segments(aln.pos, aln.cig_op, aln.cig_ln,
                                   aln.cig_off)
    per_rec = np.zeros(aln.n, np.int64)
    np.add.at(per_rec, rec, e - s)
    np.testing.assert_array_equal(per_rec, aln.nmatch.astype(np.int64))

    # -G cutoff coverage
    covg = refiner.coverage_with_cutoff(aln, lens, cutoff=0.95)
    assert (covg >= 0).all()
    # -C refine-by-reads executes and keeps a sane subset
    keep = refiner.refine_by_reads(aln, lens, cf_cutoff=0.5)
    assert 0 < len(keep) <= len(lens)


def test_real_bam_streaming_reader_matches_full():
    """The chunked streaming C++ route decodes the real file
    identically to the one-shot route."""
    path = BAMS[1]
    full = bam_io.read_bam(path)
    chunks = native.stream_bam_native(path, chunk_records=1000)
    if chunks is None:
        pytest.skip("streaming reader unavailable")
    parts = list(chunks)
    assert len(parts) > 1  # really exercised chunking
    for k in ("tid", "pos", "flag", "mapq", "nmatch", "read_len"):
        got = np.concatenate([getattr(c, k) for c in parts])
        np.testing.assert_array_equal(got, getattr(full, k), k)
