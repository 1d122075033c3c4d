"""Builds the native library from the sources in ``native/``.

It is compiled on first use into ``native/build/`` (listed in
.gitignore) and rebuilt when a source is newer than it. The compiler
writes to a temporary name that is renamed into place under a file
lock, so concurrent processes (test workers) never load a half-written
library. To build it ahead of time:

    python -m gappadder.utils.nativebuild
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")


class CompileError(RuntimeError):
    """A native library could not be compiled."""


def _fresh(out: str, sources) -> bool:
    if not os.path.exists(out):
        return False
    t = os.path.getmtime(out)
    return all(os.path.getmtime(s) <= t for s in sources)


def build(name: str, sources, command, timeout: float = 900) -> str:
    """Path of ``native/build/<name>``, compiled if missing or stale.

    sources: files whose change forces a rebuild.
    command: fn(output_path) -> argv of the compiler invocation.
    Raises CompileError with the compiler's output on failure."""
    out = os.path.join(BUILD_DIR, name)
    if _fresh(out, sources):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(out, sources):
            return out
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=name + ".",
                                   suffix=".tmp")
        os.close(fd)
        argv = command(tmp)
        try:
            if shutil.which(argv[0]) is None and not os.path.exists(argv[0]):
                raise CompileError(f"{name}: compiler {argv[0]} not found")
            res = subprocess.run(argv, capture_output=True, text=True,
                                 timeout=timeout)
            if res.returncode != 0:
                raise CompileError(
                    f"{name}: {' '.join(argv)} exited {res.returncode}:\n"
                    f"{(res.stdout + res.stderr)[-4000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _src(name: str) -> str:
    return os.path.join(NATIVE_DIR, name)


def build_bamio() -> str:
    """The BAM/FASTQ codec (native/bamio.cpp), with g++ and zlib."""
    src = _src("bamio.cpp")
    return build("libbamio.so", [src], lambda out: [
        os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC", "-Wall",
        "-pthread", "-shared", "-o", out, src, "-lz"])


if __name__ == "__main__":
    print(build_bamio())
