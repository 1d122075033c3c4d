"""Native C++ decoder parity vs the pure-Python readers."""

import numpy as np
import pytest

from gappadder.io import bam as bam_io
from gappadder.io import fastq, native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib not built")


def test_bam_native_matches_python(tmp_path, rng):
    refs = [("c1", 1000), ("c2", 500), ("long_name.scaffold-3", 77)]
    recs = []
    for i in range(50):
        cig = []
        if rng.integers(0, 2):
            cig.append(("S", int(rng.integers(1, 30))))
        cig.append(("M", int(rng.integers(10, 100))))
        if rng.integers(0, 2):
            cig.append(("S", int(rng.integers(1, 30))))
        recs.append(dict(
            name=f"read{i}/1 comment", flag=int(rng.choice([0x41, 0x85, 0x4D])),
            tid=int(rng.integers(0, 3)), pos=int(rng.integers(0, 900)),
            mapq=int(rng.choice([0, 30, 60])), cigar=cig,
            mtid=int(rng.integers(-1, 3)), mpos=int(rng.integers(0, 900)),
            tlen=int(rng.integers(-500, 500)),
            seq="ACGT" * int(rng.integers(5, 20))))
    path = str(tmp_path / "x.bam")
    bam_io.write_bam(path, refs, recs)
    a = bam_io.read_bam(path)
    b = native.read_bam_native(path)
    assert a.refs == b.refs
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
              "lclip", "rclip", "nmatch", "read_len"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.name_hash, b.name_hash)


def test_fastq_native_matches_python(tmp_path, rng):
    path = str(tmp_path / "x.fastq")
    with open(path, "w") as fh:
        for i in range(30):
            n = int(rng.integers(5, 60))
            s = "".join(np.array(list("ACGTN"))[rng.integers(0, 5, n)])
            fh.write(f"@r{i}/{1 + i % 2} extra words\n{s}\n+\n{'I' * n}\n")
    a = fastq.read_fastq(path)
    b = native.read_fastq_native(path)
    assert a.names == b.names
    np.testing.assert_array_equal(a.name_hash, b.name_hash)
    np.testing.assert_array_equal(a.length, b.length)
    L = min(a.seq.shape[1], b.seq.shape[1])
    np.testing.assert_array_equal(a.seq[:, :L], b.seq[:, :L])
    np.testing.assert_array_equal(a.qual[:, :L], b.qual[:, :L])


def test_fastq_subset(tmp_path, rng):
    path = str(tmp_path / "s.fastq")
    with open(path, "w") as fh:
        for i in range(10):
            fh.write(f"@q{i}\nACGT\n+\nIIII\n")
    rs = fastq.read_fastq(path)
    sub = fastq.subset(rs, [3, 1, 7])
    assert sub.names == [b"q3", b"q1", b"q7"]
    sub2 = fastq.subset_by_names(rs, ["q9", "missing", "q0"])
    assert sub2.names == [b"q9", b"q0"]
    assert sub2.n == 2


def test_bam_stream_matches_full_read(tmp_path, rng):
    refs = [("c1", 5000), ("c2", 900)]
    recs = []
    for i in range(997):  # non-round count exercises the last chunk
        cig = [("M", int(rng.integers(20, 120)))]
        if rng.integers(0, 2):
            cig = [("S", int(rng.integers(1, 20)))] + cig
        recs.append(dict(
            name=f"sr{i}/1", flag=int(rng.choice([0x41, 0x85])),
            tid=int(rng.integers(0, 2)), pos=int(rng.integers(0, 800)),
            mapq=int(rng.choice([0, 60])), cigar=cig,
            mtid=int(rng.integers(0, 2)), mpos=int(rng.integers(0, 800)),
            tlen=int(rng.integers(-400, 400)),
            seq="ACGT" * int(rng.integers(5, 30))))
    path = str(tmp_path / "s.bam")
    bam_io.write_bam(path, refs, recs)
    full = bam_io.read_bam(path)
    gen = native.stream_bam_native(path, chunk_records=100)
    assert gen is not None
    chunks = list(gen)
    assert sum(c.n for c in chunks) == full.n
    assert len(chunks) == 10  # 997 records in chunks of 100
    assert chunks[0].refs == full.refs
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
              "lclip", "rclip", "nmatch", "read_len"):
        got = np.concatenate([getattr(c, k) for c in chunks])
        np.testing.assert_array_equal(got, getattr(full, k), k)
    got_h = np.concatenate([c.name_hash for c in chunks])
    np.testing.assert_array_equal(got_h, full.name_hash)


def test_read_bam_any_stream_path(tmp_path, rng, monkeypatch):
    """The >threshold streaming route of read_bam_any returns the same
    Alignments as the direct decoders."""
    from gappadder.pipeline import collect as col
    refs = [("c1", 2000)]
    recs = [dict(name=f"x{i}", flag=0x41, tid=0,
                 pos=int(rng.integers(0, 1900)), mapq=60,
                 cigar=[("M", 50)], mtid=0, mpos=0, tlen=100,
                 seq="ACGT" * 10) for i in range(200)]
    path = str(tmp_path / "big.bam")
    bam_io.write_bam(path, refs, recs)
    direct = bam_io.read_bam(path)
    monkeypatch.setattr(col, "STREAM_THRESHOLD", 0)
    streamed = col.read_bam_any(path)
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
              "lclip", "rclip", "nmatch", "read_len", "name_hash"):
        np.testing.assert_array_equal(getattr(direct, k),
                                      getattr(streamed, k), k)
    assert streamed.refs == direct.refs


# ---- native writers (parallel BGZF BAM writer, buffered FASTQ writer) ----

def test_bam_write_native_roundtrip(tmp_path, rng):
    """Columnar native writer -> both readers decode identical columns."""
    from gappadder import dna
    n, L = 2000, 100
    refs = [("scaf_a", 5000), ("scaf_b", 700)]
    names = [f"w{i}/1".encode() for i in range(n)]
    flag = rng.choice([0x41, 0x85, 0x4D, 0x45], n).astype(np.int32)
    tid = rng.integers(0, 2, n).astype(np.int32)
    pos = rng.integers(0, 4000, n).astype(np.int32)
    mapq = rng.choice([0, 30, 60], n).astype(np.int32)
    mtid = rng.integers(-1, 2, n).astype(np.int32)
    mpos = rng.integers(0, 4000, n).astype(np.int32)
    tlen = rng.integers(-800, 800, n).astype(np.int32)
    lens = rng.integers(20, L + 1, n).astype(np.int32)
    lclip = np.minimum(rng.integers(0, 20, n), lens // 3).astype(np.int32)
    rclip = np.minimum(rng.integers(0, 20, n), lens // 3).astype(np.int32)
    unmapped = (flag & 4) != 0
    lclip[unmapped] = 0
    rclip[unmapped] = 0
    seq = rng.integers(0, 4, (n, L)).astype(np.int8)
    qual = np.full((n, L), ord("I"), np.uint8)

    path = str(tmp_path / "w.bam")
    ok = native.write_bam_columns_native(
        path, refs, names=names, flag=flag, tid=tid, pos=pos, mapq=mapq,
        mtid=mtid, mpos=mpos, tlen=tlen, lclip=lclip, rclip=rclip,
        seq=seq, lens=lens, qual=qual)
    assert ok

    for rd in (bam_io.read_bam, native.read_bam_native):
        a = rd(path)
        assert a.refs == ["scaf_a", "scaf_b"]
        np.testing.assert_array_equal(a.flag, flag)
        np.testing.assert_array_equal(a.tid, tid)
        np.testing.assert_array_equal(a.pos, pos)
        np.testing.assert_array_equal(a.mapq, mapq)
        np.testing.assert_array_equal(a.mtid, mtid)
        np.testing.assert_array_equal(a.mpos, mpos)
        np.testing.assert_array_equal(a.tlen, tlen)
        np.testing.assert_array_equal(a.lclip, lclip)
        np.testing.assert_array_equal(a.rclip, rclip)
        np.testing.assert_array_equal(a.read_len, lens)
        want_match = np.where(unmapped, 0, lens - lclip - rclip)
        np.testing.assert_array_equal(a.nmatch, want_match)
    # names survive via hash join
    a = bam_io.read_bam(path, keep_names=True)
    assert a.names[:3] == [b"w0", b"w1", b"w2"]


def test_bam_write_columns_fallback_matches_native(tmp_path, rng):
    """The Python fallback path of write_bam_columns produces the same
    decoded columns as the native writer."""
    from gappadder.io import native as native_mod
    n, L = 40, 60
    refs = [("s", 900)]
    kw = dict(
        names=[f"q{i}".encode() for i in range(n)],
        flag=np.zeros(n, np.int32), tid=np.zeros(n, np.int32),
        pos=np.arange(n, dtype=np.int32) * 10,
        mapq=np.full(n, 60, np.int32),
        mtid=np.full(n, -1, np.int32), mpos=np.zeros(n, np.int32),
        tlen=np.zeros(n, np.int32),
        lclip=np.full(n, 5, np.int32), rclip=np.zeros(n, np.int32),
        seq=rng.integers(0, 4, (n, L)).astype(np.int8),
        lens=np.full(n, L, np.int32))
    p1 = str(tmp_path / "nat.bam")
    p2 = str(tmp_path / "py.bam")
    bam_io.write_bam_columns(p1, refs, **kw)
    import unittest.mock as mock
    with mock.patch.object(native_mod, "write_bam_columns_native",
                           return_value=False):
        bam_io.write_bam_columns(p2, refs, **kw)
    a, b = bam_io.read_bam(p1), bam_io.read_bam(p2)
    for k in ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
              "lclip", "rclip", "nmatch", "read_len"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.name_hash, b.name_hash)


def test_fastq_write_native_matches_python(tmp_path, rng):
    """Native buffered writer emits byte-identical FASTQ to the Python
    writer (incl. suffix renaming and row selection/order)."""
    from gappadder.io import native as native_mod
    n, L = 200, 80
    lens = rng.integers(10, L + 1, n).astype(np.int32)
    seq = np.full((n, L), 4, np.int8)
    qual = np.zeros((n, L), np.uint8)
    for i in range(n):
        seq[i, :lens[i]] = rng.integers(0, 4, lens[i])
        qual[i, :lens[i]] = rng.integers(33, 74, lens[i])
    rs = fastq.ReadSet(seq=seq, length=lens, qual=qual,
                       name_hash=np.zeros(n, np.uint64),
                       names=[f"r{i}".encode() for i in range(n)])
    rows = rng.permutation(n)[:77]
    p1 = str(tmp_path / "nat.fastq")
    p2 = str(tmp_path / "py.fastq")
    fastq.write_fastq(p1, rs, rows, suffix="_1")
    import unittest.mock as mock
    with mock.patch.object(native_mod, "write_fastq_native",
                           return_value=False):
        fastq.write_fastq(p2, rs, rows, suffix="_1")
    assert open(p1, "rb").read() == open(p2, "rb").read()
    # append mode stacks records
    ok = native.write_fastq_native(p1, rs, rows[:5], suffix="_2",
                                   append=True)
    assert ok
    got = fastq.read_fastq(p1)
    assert got.n == 82


def _raw_bam_records(path):
    """Decode BAM payload into (name, qual_bytes) pairs for testing."""
    import struct
    raw = bam_io._bgzf_decompress(open(path, "rb").read())
    l_text = struct.unpack_from("<i", raw, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        off += 4 + l_name + 4
    out = []
    while off < len(raw):
        bsz = struct.unpack_from("<i", raw, off)[0]
        rec = raw[off + 4: off + 4 + bsz]
        off += 4 + bsz
        (_tid, _pos, l_rn, _mapq, _bin, n_cig, _flag, l_seq, _mtid,
         _mpos, _tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
        name = rec[32: 32 + l_rn - 1]
        qoff = 32 + l_rn + 4 * n_cig + (l_seq + 1) // 2
        out.append((name, rec[qoff: qoff + l_seq]))
    return out


def test_bam_write_fallback_preserves_qual(tmp_path, rng):
    """ADVICE r1: the Python fallback must carry phred scores like the
    native path instead of emitting 0xFF."""
    from gappadder.io import native as native_mod
    n, L = 8, 30
    refs = [("s", 500)]
    qual = rng.integers(35, 70, (n, L)).astype(np.uint8)
    kw = dict(
        names=[f"q{i}".encode() for i in range(n)],
        flag=np.zeros(n, np.int32), tid=np.zeros(n, np.int32),
        pos=np.arange(n, dtype=np.int32), mapq=np.full(n, 60, np.int32),
        mtid=np.full(n, -1, np.int32), mpos=np.zeros(n, np.int32),
        tlen=np.zeros(n, np.int32), lclip=np.zeros(n, np.int32),
        rclip=np.zeros(n, np.int32),
        seq=rng.integers(0, 4, (n, L)).astype(np.int8),
        lens=np.full(n, L, np.int32), qual=qual)
    p1 = str(tmp_path / "nat.bam")
    p2 = str(tmp_path / "py.bam")
    bam_io.write_bam_columns(p1, refs, **kw)
    import unittest.mock as mock
    with mock.patch.object(native_mod, "write_bam_columns_native",
                           return_value=False):
        bam_io.write_bam_columns(p2, refs, **kw)
    r1, r2 = _raw_bam_records(p1), _raw_bam_records(p2)
    for (n1, q1), (n2, q2) in zip(r1, r2):
        assert n1 == n2
        assert q1 == q2
        assert q1 != b"\xff" * len(q1)
    # stored phred = input - 33
    np.testing.assert_array_equal(
        np.frombuffer(r1[0][1], np.uint8), qual[0] - 33)


def test_bam_write_native_clamps_long_names(tmp_path):
    """ADVICE r1: QNAME > 254 bytes must clamp (samtools limit), not
    wrap l_read_name and corrupt the record."""
    n, L = 3, 20
    refs = [("s", 500)]
    names = [b"x" * 300, b"ok_name", b"y" * 254]
    kw = dict(
        names=names,
        flag=np.zeros(n, np.int32), tid=np.zeros(n, np.int32),
        pos=np.arange(n, dtype=np.int32), mapq=np.full(n, 60, np.int32),
        mtid=np.full(n, -1, np.int32), mpos=np.zeros(n, np.int32),
        tlen=np.zeros(n, np.int32), lclip=np.zeros(n, np.int32),
        rclip=np.zeros(n, np.int32),
        seq=np.zeros((n, L), np.int8), lens=np.full(n, L, np.int32))
    path = str(tmp_path / "long.bam")
    ok = native.write_bam_columns_native(path, refs, **kw)
    assert ok
    recs = _raw_bam_records(path)
    assert [r[0] for r in recs] == [b"x" * 254, b"ok_name", b"y" * 254]
    a = bam_io.read_bam(path)   # parses cleanly end to end
    assert a.n == n
