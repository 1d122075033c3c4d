"""ctypes bindings for the native (C++) BAM/FASTQ decoder.

Loads native/build/libbamio.so, compiled from native/bamio.cpp on first
use (utils/nativebuild.py). When it cannot be built or loaded, the
reason is logged once, kept in ``failure_reason()``, and callers use
the pure-Python readers, which give the same columnar outputs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import log, nativebuild

_LIB = None
_TRIED = False
_REASON: str | None = None


def failure_reason() -> str | None:
    """Why the native library is unavailable (None when it loaded)."""
    _load()
    return _REASON


def _load():
    global _LIB, _TRIED, _REASON
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(nativebuild.build_bamio())
    except (nativebuild.CompileError, OSError) as e:
        _REASON = f"{type(e).__name__}: {e}"
        log.logger.warning("native BAM/FASTQ codec unavailable, using the "
                           "Python readers: %s", _REASON)
        return None
    lib.bam_open.restype = ctypes.c_void_p
    lib.bam_open.argtypes = [ctypes.c_char_p]
    lib.bam_num_records.restype = ctypes.c_int64
    lib.bam_num_records.argtypes = [ctypes.c_void_p]
    lib.bam_refs_len.restype = ctypes.c_int64
    lib.bam_refs_len.argtypes = [ctypes.c_void_p]
    lib.bam_copy_refs.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bam_copy_columns.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.bam_close.argtypes = [ctypes.c_void_p]
    lib.fastq_open.restype = ctypes.c_void_p
    lib.fastq_open.argtypes = [ctypes.c_char_p]
    lib.fastq_num.restype = ctypes.c_int64
    lib.fastq_num.argtypes = [ctypes.c_void_p]
    lib.fastq_max_len.restype = ctypes.c_int32
    lib.fastq_max_len.argtypes = [ctypes.c_void_p]
    lib.fastq_names_len.restype = ctypes.c_int64
    lib.fastq_names_len.argtypes = [ctypes.c_void_p]
    lib.fastq_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.fastq_close.argtypes = [ctypes.c_void_p]
    lib.fastq_scan_open.restype = ctypes.c_void_p
    lib.fastq_scan_open.argtypes = [ctypes.c_char_p]
    lib.fastq_scan_num.restype = ctypes.c_int64
    lib.fastq_scan_num.argtypes = [ctypes.c_void_p]
    lib.fastq_scan_max_len.restype = ctypes.c_int32
    lib.fastq_scan_max_len.argtypes = [ctypes.c_void_p]
    lib.fastq_scan_copy.argtypes = [ctypes.c_void_p] + \
        [ctypes.c_void_p] * 6
    lib.fastq_scan_close.argtypes = [ctypes.c_void_p]
    lib.bam_stream_open.restype = ctypes.c_void_p
    lib.bam_stream_open.argtypes = [ctypes.c_char_p]
    lib.bam_stream_refs_len.restype = ctypes.c_int64
    lib.bam_stream_refs_len.argtypes = [ctypes.c_void_p]
    lib.bam_stream_copy_refs.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bam_stream_next.restype = ctypes.c_int64
    lib.bam_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bam_stream_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.bam_stream_close.argtypes = [ctypes.c_void_p]
    lib.bam_write.restype = ctypes.c_int32
    lib.bam_write.argtypes = ([ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_int64, ctypes.c_char_p] +
                              [ctypes.c_void_p] * 11 +
                              [ctypes.c_int32] + [ctypes.c_void_p] * 2)
    lib.fastq_write.restype = ctypes.c_int32
    lib.fastq_write.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_void_p,
                                ctypes.c_int32, ctypes.c_void_p,
                                ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_bam_native(path: str):
    """Returns an io.bam.Alignments or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.bam_open(path.encode())
    if not h:
        return None
    try:
        n = lib.bam_num_records(h)
        cols = np.empty((11, n), np.int32)
        hashes = np.empty(n, np.uint64)
        lib.bam_copy_columns(h, cols.ctypes.data_as(ctypes.c_void_p),
                             hashes.ctypes.data_as(ctypes.c_void_p))
        rl = lib.bam_refs_len(h)
        buf = ctypes.create_string_buffer(int(rl))
        lib.bam_copy_refs(h, buf)
        refs = buf.raw.decode().split("\n") if rl else []
    finally:
        lib.bam_close(h)
    from .bam import Alignments
    keys = ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
            "lclip", "rclip", "nmatch", "read_len")
    kw = {k: cols[i].copy() for i, k in enumerate(keys)}
    return Alignments(**kw, name_hash=hashes, refs=refs, names=None)


def stream_bam_native(path: str, chunk_records: int = 1 << 20):
    """Bounded-memory BAM reader: yields io.bam.Alignments chunks.

    Returns None when the native library is unavailable. Only the
    BGZF block currently being decoded (plus a small carry) is held in
    memory — suitable for production-scale BAMs."""
    lib = _load()
    if lib is None:
        return None

    def gen():
        h = lib.bam_stream_open(path.encode())
        if not h:
            raise IOError(f"cannot open BAM stream: {path}")
        try:
            rl = lib.bam_stream_refs_len(h)
            buf = ctypes.create_string_buffer(max(int(rl), 1))
            lib.bam_stream_copy_refs(h, buf)
            refs = buf.raw[:rl].decode().split("\n") if rl else []
            from .bam import Alignments
            keys = ("tid", "pos", "flag", "mapq", "mtid", "mpos", "tlen",
                    "lclip", "rclip", "nmatch", "read_len")
            while True:
                n = int(lib.bam_stream_next(h, chunk_records))
                if n <= 0:
                    break
                cols = np.empty((11, n), np.int32)
                hashes = np.empty(n, np.uint64)
                lib.bam_stream_copy(h, cols.ctypes.data_as(ctypes.c_void_p),
                                    hashes.ctypes.data_as(ctypes.c_void_p))
                kw = {k: cols[i].copy() for i, k in enumerate(keys)}
                yield Alignments(**kw, name_hash=hashes, refs=refs,
                                 names=None)
        finally:
            lib.bam_stream_close(h)

    return gen()


def read_fastq_native(path: str):
    """Returns an io.fastq.ReadSet or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastq_open(path.encode())
    if not h:
        return None
    try:
        n = int(lib.fastq_num(h))
        L = int(lib.fastq_max_len(h))
        nl = int(lib.fastq_names_len(h))
        seq = np.empty((n, L), np.int8)
        qual = np.empty((n, L), np.uint8)
        lens = np.empty(n, np.int32)
        hashes = np.empty(n, np.uint64)
        name_off = np.empty(n + 1, np.int32)
        names_buf = ctypes.create_string_buffer(max(nl, 1))
        lib.fastq_copy(h, seq.ctypes.data_as(ctypes.c_void_p),
                       qual.ctypes.data_as(ctypes.c_void_p),
                       lens.ctypes.data_as(ctypes.c_void_p),
                       hashes.ctypes.data_as(ctypes.c_void_p),
                       name_off.ctypes.data_as(ctypes.c_void_p),
                       names_buf)
    finally:
        lib.fastq_close(h)
    blob = names_buf.raw[:nl]
    names = [blob[name_off[i]:name_off[i + 1]] for i in range(n)]
    from .fastq import ReadSet
    return ReadSet(seq=seq, length=lens, qual=qual, name_hash=hashes,
                   names=names)


def scan_fastq_native(path: str):
    """Streaming offset scan (no payloads); dict of LazyReadSet fields
    minus `path`, or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastq_scan_open(path.encode())
    if not h:
        return None
    try:
        n = int(lib.fastq_scan_num(h))
        max_len = int(lib.fastq_scan_max_len(h))
        hashes = np.empty(n, np.uint64)
        lens = np.empty(n, np.int32)
        seq_off = np.empty(n, np.int64)
        qual_off = np.empty(n, np.int64)
        name_off = np.empty(n, np.int64)
        name_len = np.empty(n, np.int32)
        lib.fastq_scan_copy(
            h, hashes.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            seq_off.ctypes.data_as(ctypes.c_void_p),
            qual_off.ctypes.data_as(ctypes.c_void_p),
            name_off.ctypes.data_as(ctypes.c_void_p),
            name_len.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.fastq_scan_close(h)
    return dict(name_hash=hashes, length=lens, seq_off=seq_off,
                qual_off=qual_off, name_off=name_off,
                name_len=name_len, max_len=max_len)


def _names_blob(names) -> tuple[bytes, np.ndarray]:
    off = np.zeros(len(names) + 1, np.int32)
    for i, nm in enumerate(names):
        off[i + 1] = off[i] + len(nm)
    return b"".join(names), off


def write_fastq_native(path: str, readset, rows, suffix: str = "",
                       append: bool = False) -> bool:
    """Buffered C++ FASTQ writer; returns False when unavailable
    (callers fall back to the Python writer)."""
    lib = _load()
    if lib is None:
        return False
    rows = np.asarray(rows, np.int64)
    seq = np.ascontiguousarray(readset.seq[rows], np.int8)
    qual = np.ascontiguousarray(readset.qual[rows], np.uint8)
    lens = np.ascontiguousarray(readset.length[rows], np.int32)
    blob, off = _names_blob([readset.names[int(r)] for r in rows])
    stride = seq.shape[1] if seq.ndim == 2 and seq.shape[0] else 0
    rc = lib.fastq_write(
        path.encode(), 1 if append else 0, len(rows), None, blob,
        off.ctypes.data_as(ctypes.c_void_p), suffix.encode(),
        seq.ctypes.data_as(ctypes.c_void_p), stride,
        lens.ctypes.data_as(ctypes.c_void_p),
        qual.ctypes.data_as(ctypes.c_void_p))
    return bool(rc)


def write_bam_columns_native(path: str, refs, *, names, flag, tid, pos,
                             mapq, mtid, mpos, tlen, lclip, rclip, seq,
                             lens, qual=None) -> bool:
    """Columnar BAM writer with parallel BGZF deflate; returns False
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    n = len(flag)
    refs_blob = "\n".join(name for name, _ in refs).encode()
    ref_lens = np.asarray([ln for _, ln in refs], np.int32)
    blob, off = _names_blob([nm.encode() if isinstance(nm, str) else nm
                             for nm in names])
    seq = np.ascontiguousarray(seq, np.int8)
    stride = seq.shape[1] if seq.ndim == 2 and seq.shape[0] else 0

    keep = []  # hold array refs so pointers stay valid across the call

    def c(a):
        a = np.ascontiguousarray(a, np.int32)
        keep.append(a)
        return a.ctypes.data_as(ctypes.c_void_p)

    qual_ptr = None
    if qual is not None:
        qual = np.ascontiguousarray(qual, np.uint8)
        qual_ptr = qual.ctypes.data_as(ctypes.c_void_p)
    rc = lib.bam_write(
        path.encode(), refs_blob,
        ref_lens.ctypes.data_as(ctypes.c_void_p), len(refs), n, blob,
        off.ctypes.data_as(ctypes.c_void_p),
        c(tid), c(pos), c(flag), c(mapq), c(mtid), c(mpos), c(tlen),
        c(lclip), c(rclip), seq.ctypes.data_as(ctypes.c_void_p), stride,
        c(lens), qual_ptr)
    return bool(rc)
