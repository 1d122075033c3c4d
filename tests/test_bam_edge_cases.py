"""CIGAR/flag edge-case fuzz for the BAM decode path (SURVEY §7
hardening item: CIGAR/flag fuzz)."""

import numpy as np
import pytest

from gappadder.io import bam as bam_io, native


def _roundtrip(tmp_path, recs):
    path = str(tmp_path / "edge.bam")
    bam_io.write_bam(path, [("c", 10000)], recs)
    return bam_io.read_bam(path, keep_names=True)


def test_cigar_op_zoo(tmp_path):
    recs = [
        dict(name="hardclip", flag=0, tid=0, pos=1, cigar=[("H", 9), ("M", 30), ("H", 2)], mtid=-1, mpos=-1, tlen=0),
        dict(name="single_s", flag=0, tid=0, pos=2, cigar=[("S", 50)], mtid=-1, mpos=-1, tlen=0),
        dict(name="eq_x_ops", flag=0, tid=0, pos=3, cigar=[("=", 10), ("X", 5), ("=", 10)], mtid=-1, mpos=-1, tlen=0),
        dict(name="with_intron", flag=0, tid=0, pos=4, cigar=[("M", 10), ("N", 100), ("M", 10)], mtid=-1, mpos=-1, tlen=0),
        dict(name="indels", flag=0, tid=0, pos=5, cigar=[("S", 3), ("M", 10), ("I", 4), ("M", 5), ("D", 2), ("M", 8), ("S", 7)], mtid=-1, mpos=-1, tlen=0),
        dict(name="unmapped", flag=4, tid=-1, pos=-1, cigar=[], mtid=-1, mpos=-1, tlen=0),
    ]
    a = _roundtrip(tmp_path, recs)
    by = {n.decode(): i for i, n in enumerate(a.names)}
    assert a.lclip[by["hardclip"]] == 9 and a.rclip[by["hardclip"]] == 2
    assert a.nmatch[by["hardclip"]] == 30
    # single-op S counts as clipped on BOTH sides (reference is_clipped)
    assert a.lclip[by["single_s"]] == 50 and a.rclip[by["single_s"]] == 50
    assert a.nmatch[by["eq_x_ops"]] == 25        # = and X count as aligned
    assert a.nmatch[by["with_intron"]] == 20     # N skip not aligned
    assert a.nmatch[by["indels"]] == 23
    assert a.lclip[by["indels"]] == 3 and a.rclip[by["indels"]] == 7
    assert a.nmatch[by["unmapped"]] == 0


def test_native_matches_python_on_edge_cases(tmp_path):
    if not native.available():
        pytest.skip("native lib not built")
    recs = [
        dict(name="hardclip", flag=0x841, tid=0, pos=1,
             cigar=[("H", 9), ("M", 30), ("H", 2)], mtid=0, mpos=50, tlen=80),
        dict(name="single_s", flag=0x585, tid=0, pos=2, cigar=[("S", 50)],
             mtid=-1, mpos=-1, tlen=0),
        dict(name="weird/1 with spaces", flag=0, tid=0, pos=3,
             cigar=[("=", 10), ("X", 5)], mtid=-1, mpos=-1, tlen=-1),
    ]
    path = str(tmp_path / "edge2.bam")
    bam_io.write_bam(path, [("c", 10000)], recs)
    a = bam_io.read_bam(path)
    b = native.read_bam_native(path)
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
              "lclip", "rclip", "nmatch", "read_len"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.name_hash, b.name_hash)


def test_bai_chunk_end_at_exact_block_boundary(tmp_path):
    """A record whose uncompressed end offset is an exact multiple of
    the BGZF block size must get a chunk-END virtual offset at the
    start of the NEXT block (the EOF block when it is the last record)
    — clamping it into the last data block would invert the chunk and
    make index-based readers skip the final block (ADVICE r3)."""
    import struct

    # one data block of coffset 0, EOF block at coffset 777
    coffs = [0, 777]
    chunk = 0xFF00
    spans = [(0, 10, 50, chunk - 64, chunk)]   # u_end == block boundary
    raw = bam_io._build_bai(1, spans, coffs)
    assert raw[:4] == b"BAI\x01"
    n_ref, = struct.unpack_from("<i", raw, 4)
    assert n_ref == 1
    n_bin, = struct.unpack_from("<i", raw, 8)
    assert n_bin == 1
    _bin, n_chunk = struct.unpack_from("<Ii", raw, 12)
    assert n_chunk == 1
    v0, v1 = struct.unpack_from("<QQ", raw, 20)
    assert v0 == (0 << 16) | (chunk - 64)
    assert v1 == (777 << 16), "chunk end must map to the next block"
    assert v1 > v0, "inverted chunk"


def test_write_bam_bai_end_offsets_monotonic(tmp_path):
    """End-to-end: .bai chunks written by write_bam are never inverted,
    including when the payload lands on a block boundary."""
    import struct

    refs = [("scaf0", 100000)]
    recs = []
    rng = np.random.default_rng(0)
    for i in range(2000):
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 100))
        recs.append(dict(name=f"r{i}", flag=0, tid=0, pos=10 + i * 3,
                         mapq=60, mtid=-1, mpos=-1, tlen=0, seq=seq,
                         cigar=[("M", 100)]))
    path = str(tmp_path / "x.bam")
    bam_io.write_bam(path, refs, recs, index=True)
    raw = open(path + ".bai", "rb").read()
    off = 8
    n_bin, = struct.unpack_from("<i", raw, off)
    off += 4
    for _ in range(n_bin):
        _b, n_chunk = struct.unpack_from("<Ii", raw, off)
        off += 8
        for _ in range(n_chunk):
            v0, v1 = struct.unpack_from("<QQ", raw, off)
            off += 16
            assert v1 > v0
