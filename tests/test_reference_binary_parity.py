"""Direct output parity against the REFERENCE ContigsMerger binary.

The reference's ContigsMerger builds from plain g++ + zlib + pthread
(no BamTools), so we can compile it from /root/reference at test time
and compare our merge engine's merged sequences against the actual
binary's output on the same inputs with the pipeline's exact
parameters (-s 0.4 -i1 -2.0 -i2 -2.0 -x 12 -y 50 -k 10 -m 1,
/root/reference/MergeContigs.py:85-88). This is an ORACLE BUILD for
testing only — no reference code enters the repo.

The binary is built with AddressSanitizer and run with the mismatch
checks suppressed: the 2017 code has real alloc/dealloc-type mismatches
(new[] freed with delete, derived deleted via wrong-size base) that
corrupt the modern glibc heap and segfault a plain build — ASan's
allocator tolerates them, reproducing the behavior the tool had on its
original toolchain.

Skips cleanly when the reference tree or toolchain is unavailable.
"""

import glob
import os
import shutil
import subprocess

import numpy as np
import pytest

from gappadder import dna
from gappadder.ops.merge_engine import MergeConfig, merge_contigs

REF = "/root/reference/ContigsCompactor-v0.2.0/ContigsMerger"
BIN_CACHE = "/tmp/gpt_ref_contigsmerger/ContigsMerger"


@pytest.fixture(scope="module")
def ref_binary():
    if not os.path.isdir(REF) or shutil.which("g++") is None:
        pytest.skip("reference ContigsMerger sources or g++ unavailable")
    if not os.path.exists(BIN_CACHE):
        bdir = os.path.dirname(BIN_CACHE)
        shutil.rmtree(bdir, ignore_errors=True)
        os.makedirs(bdir)
        for f in glob.glob(os.path.join(REF, "*.cpp")) + \
                glob.glob(os.path.join(REF, "*.h")):
            base = os.path.basename(f)
            if base == "ContigsCompactor1.cpp" or base.endswith(".bak"):
                continue
            shutil.copy(f, bdir)
        r = subprocess.run(
            ["g++", "-O0", "-w", "-fsanitize=address", "-o", BIN_CACHE] +
            sorted(glob.glob(os.path.join(bdir, "*.cpp"))) +
            ["-lz", "-lpthread"],
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            pytest.skip(f"oracle build failed: {r.stderr[-500:]}")
    return BIN_CACHE


ASAN_ENV = dict(os.environ,
                ASAN_OPTIONS="alloc_dealloc_mismatch=0:"
                             "new_delete_type_mismatch=0:detect_leaks=0")


def run_reference_merger(binary, contigs, names, tmpdir, extra_args=()):
    fa = os.path.join(tmpdir, "in.fa")
    with open(fa, "w") as fh:
        for n, c in zip(names, contigs):
            fh.write(f">{n}\n{dna.decode(c)}\n")
    info = os.path.join(tmpdir, "out.info")
    r = subprocess.run(
        [binary, "-s", "0.4", "-i1", "-2.0", "-i2", "-2.0", "-x", "12",
         "-y", "50", "-k", "10", "-t", "1", "-m", "1", "-o", info]
        + list(extra_args) + [fa],
        capture_output=True, text=True, timeout=300, cwd=tmpdir,
        env=ASAN_ENV)
    assert r.returncode == 0, r.stderr[-500:]
    merged = {}
    name = None
    for line in r.stdout.splitlines():
        if line.startswith(">"):
            name = line[1:].split()[0]
            merged[name] = ""
        elif name is not None:
            merged[name] += line.strip()
    info_lines = []
    if os.path.exists(info):
        with open(info) as fh:
            info_lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    return ({k: v for k, v in merged.items()
             if k.startswith("NEW_CONTIG_MERGE")}, info_lines)


def canon(seq_str):
    c = dna.encode(seq_str)
    r = dna.revcomp(c)
    return min(dna.decode(c), dna.decode(r))


@pytest.mark.parametrize("case", ["chain", "revcomp", "no_overlap"])
def test_merge_matches_reference_binary(ref_binary, tmp_path, rng, case):
    """Clean merge scenarios: our merged super-contigs must equal the
    reference binary's NEW_CONTIG_MERGE output (up to strand/name)."""
    truth = rng.integers(0, 4, 700).astype(np.int8)
    if case == "chain":
        frags = [truth[0:300], truth[250:520], truth[470:700]]
    elif case == "revcomp":
        frags = [truth[0:300], dna.revcomp(truth[250:520]),
                 truth[470:700]]
    else:  # disjoint fragments: nothing merges
        frags = [truth[0:200], truth[300:500]]
    names = [f"c{i}" for i in range(len(frags))]

    ref, _ri = run_reference_merger(ref_binary, frags, names,
                                    str(tmp_path))
    ours, _info = merge_contigs([np.asarray(f) for f in frags],
                                MergeConfig())

    ref_set = sorted(canon(s) for s in ref.values())
    our_set = sorted(canon(dna.decode(np.asarray(m))) for m in ours)
    if case == "no_overlap":
        assert ref_set == [] and our_set == []
    else:
        assert canon(dna.decode(truth)) in ref_set
        assert our_set == ref_set


def test_merge_matches_reference_binary_randomized(ref_binary, tmp_path,
                                                   rng):
    """Randomized chains of 2-5 fragments with 20-80bp overlaps, some
    strand-flipped: EXACT output-MULTISET parity with the reference
    binary on every trial (round-3: the engine now mirrors the
    reference's single-evaluation-per-pair direction choice, end-scan
    tie-break, concat merged-string, weak containment veto, interleaved
    node order and per-root path cap exactly)."""
    agree = 0
    total = 12
    for trial in range(total):
        L = int(rng.integers(400, 900))
        truth = rng.integers(0, 4, L).astype(np.int8)
        nf = int(rng.integers(2, 6))
        cuts = np.sort(rng.choice(np.arange(50, L - 50), nf - 1,
                                  replace=False))
        bounds = [0] + list(cuts) + [L]
        frags = []
        for i in range(nf):
            a = max(0, bounds[i] - (int(rng.integers(20, 80))
                                    if i else 0))
            b = min(L, bounds[i + 1] + 20)
            f = truth[a:b].copy()
            if rng.random() < 0.4:
                f = dna.revcomp(f)
            frags.append(f)
        if min(len(f) for f in frags) < 60:
            total -= 1
            continue
        names = [f"c{i}" for i in range(nf)]
        d = tmp_path / f"t{trial}"
        d.mkdir()
        ref, _ri = run_reference_merger(ref_binary, frags, names, str(d))
        ours, _ = merge_contigs([np.asarray(f) for f in frags],
                                MergeConfig())
        ref_set = sorted(canon(s) for s in ref.values())
        our_set = sorted(canon(dna.decode(np.asarray(m))) for m in ours)
        assert ref_set == our_set, (trial, ref_set, our_set)
        agree += 1
        t = canon(dna.decode(truth))
        assert (t in ref_set) == (t in our_set), trial
    assert agree == total, (agree, total)


def _canon_members(members):
    """Path member list up to strand: a path and its reverse with every
    member's _R toggled describe the same merged contig."""
    def flip(n):
        return n[:-2] if n.endswith("_R") else n + "_R"
    rev = [flip(n) for n in reversed(members)]
    return min(members, rev)


def test_merge_info_matches_reference_binary(ref_binary, tmp_path, rng):
    """The -o .merge.info provenance (which source contigs, in path
    order, formed each NEW_CONTIG_MERGE_*) must agree with our
    merge_info_lines, as a multiset of strand-canonicalized member
    paths (numbering/orientation may legitimately differ)."""
    from gappadder.ops.merge_engine import merge_info_lines
    truth = rng.integers(0, 4, 800).astype(np.int8)
    frags = [truth[0:300], dna.revcomp(truth[250:520]), truth[470:800]]
    names = [f"c{i}" for i in range(len(frags))]
    ref, ref_info = run_reference_merger(ref_binary, frags, names,
                                         str(tmp_path))
    assert ref_info, "binary produced no .merge.info"
    ours, infos = merge_contigs([np.asarray(f) for f in frags],
                                MergeConfig())
    lines = merge_info_lines(names, infos)
    # same line syntax: NAME + two spaces + (" member")*
    for ln in lines:
        assert ln.startswith("NEW_CONTIG_MERGE_") and "   " in ln, ln

    def members_of(lines_):
        out = []
        for ln in lines_:
            _name, rest = ln.split("  ", 1)
            out.append(_canon_members(rest.split()))
        return sorted(out)

    assert members_of(lines) == members_of(ref_info)
    # numbering parity: the binary's counter starts at 1 and advances
    # only on emission (static contigNumNext, ContigsCompactor.cpp:929)
    assert sorted(ln.split("  ", 1)[0] for ln in lines) == \
        sorted(ln.split("  ", 1)[0] for ln in ref_info)


def test_merge_gml_matches_reference_binary(ref_binary, tmp_path, rng):
    """tmp.gml graph dump: byte-exact parity with the binary's
    OutputGML (GraphUtils.cpp:1187-1256) on a merge scenario."""
    from gappadder.ops.merge_engine import merge_graph_gml
    truth = rng.integers(0, 4, 700).astype(np.int8)
    frags = [truth[0:300], truth[250:520], truth[470:700]]
    names = [f"c{i}" for i in range(len(frags))]
    run_reference_merger(ref_binary, frags, names, str(tmp_path))
    ref_gml = open(os.path.join(str(tmp_path), "tmp.gml")).read()
    graph = {}
    merge_contigs([np.asarray(f) for f in frags], MergeConfig(),
                  graph_out=graph)
    assert merge_graph_gml(names, graph) == ref_gml


def test_merge_p2_path_cap_matches_reference_binary(ref_binary, tmp_path,
                                                    rng):
    """-p2 maxCountContigInPath (ContigsMerger/main.cpp:192-198): the
    per-root path cap fed to FindSimplePathsTopSort. A star scenario
    (one left fragment overlapping many distinct right fragments) has
    many paths from one root; -p2 1 must CHANGE the answer (cap+1 = 2
    paths emitted per root, the reference's numOut > cap quirk) and our
    MergeConfig.max_paths_per_root must match the binary at both
    settings."""
    # complete bipartite overlap: 3 starts Ai all ending in the same
    # 50 bp T, 4 ends Ej all beginning with T -> 12 (Ai, Ej) paths.
    # Per-root caps bite on BOTH orientations here (each Ai root has 4
    # ends, each Ej_R twin root has 3 starts), so capped paths cannot
    # all be refilled by their revcomp twins — a one-sided star's can.
    T = rng.integers(0, 4, 50).astype(np.int8)
    starts = [np.concatenate([rng.integers(0, 4, 150).astype(np.int8), T])
              for _ in range(3)]
    ends = [np.concatenate([T, rng.integers(0, 4, 150).astype(np.int8)])
            for _ in range(4)]
    frags = starts + ends
    names = [f"c{i}" for i in range(len(frags))]

    for p2, ours_cap in ((1, 1), (20, 20)):
        d = tmp_path / f"p2_{p2}"
        d.mkdir()
        ref, _ = run_reference_merger(ref_binary, frags, names, str(d),
                                      extra_args=("-p2", str(p2)))
        ours, _i = merge_contigs(
            [np.asarray(f) for f in frags],
            MergeConfig(max_paths_per_root=ours_cap))
        ref_set = sorted(canon(s) for s in ref.values())
        our_set = sorted(canon(dna.decode(np.asarray(m))) for m in ours)
        assert our_set == ref_set, f"-p2 {p2}"
        if p2 == 1:
            n_capped = len(ref_set)
        else:
            n_full = len(ref_set)
    assert n_capped < n_full, "cap did not change the answer"
