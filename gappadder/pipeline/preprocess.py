"""Preprocess stage: gap positions + flank extraction.

Equivalent of ``main.py -c Preprocess`` in the reference
(/root/reference/main.py:222-225 -> gnrt_pos_true_seqs.py:12-100), but
as one batched device computation over the whole concatenated genome
instead of a per-scaffold Python string scan, and with the gap-id
contract ("<scaffold_idx>_<n>", n from 1) made explicit in a table that
every later stage consumes (the reference re-derives it in four
modules — SURVEY.md §1).

Outputs (in the workspace):
  gaps.npz      columns: start/end (global), scaffold, number,
                local_start/local_end, flank arrays + lengths
  gap_positions.txt   reference-format text file (parity/debug)
  flank_regions/<gap_id>.fa  (optional, parity/debug)
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np


from ..config import Config
from ..io import fasta
from ..ops import gapscan
from .workspace import Workspace, config_hash


def gap_ids(gaps: dict[str, np.ndarray]) -> list[str]:
    """Format the reference gap-id strings for a gap table."""
    return [f"{s}_{n}" for s, n in zip(gaps["scaffold"], gaps["number"])]


def run_preprocess(cfg: Config, ws: Workspace | None = None,
                   genome: fasta.Genome | None = None,
                   write_parity_files: bool = False) -> dict[str, np.ndarray]:
    """Scan the draft genome, extract flanks, checkpoint the gap table."""
    if genome is None:
        genome = fasta.read_fasta(cfg.draft_genome)
    gaps = gapscan.scan_genome_np(genome, cfg.min_gap_size)
    n = len(gaps["start"])

    scaf = gaps["scaffold"]
    scaf_begin = genome.offsets[scaf] if n else np.zeros(0, np.int64)
    scaf_end = (genome.offsets[scaf] + genome.lengths[scaf]) if n else np.zeros(0, np.int64)

    seq = genome.seq
    if seq.shape[0] <= gapscan.HOST_SCAN_MAX:
        # small drafts: the host twin avoids the device round trip
        # entirely (transfer + dispatch latency would dominate)
        left, right, left_len, right_len = gapscan.extract_flanks_host(
            seq, gaps["start"], gaps["end"], scaf_begin, scaf_end,
            flank_len=cfg.flank_length, margin=cfg.flank_margin)
        left, right = np.asarray(left), np.asarray(right)
        left_len, right_len = np.asarray(left_len), np.asarray(right_len)
    else:
        # bucket the genome and gap axes so drafts of similar size
        # reuse compiled shapes (remote compiles dominate cold runs)
        Lb = gapscan.length_bucket(max(seq.shape[0], 1))
        if Lb != seq.shape[0]:
            import gappadder.dna as dna
            seq = np.concatenate([seq, np.full(Lb - seq.shape[0],
                                               dna.SEP, np.int8)])
        Gb = max(16, 1 << (max(n, 1) - 1).bit_length())

        def _pad(a, fill, dtype=np.int32):
            out = np.full(Gb, fill, dtype)
            out[:n] = a
            return jnp.asarray(out)

        left, right, left_len, right_len = (
            np.asarray(x)[:n] for x in gapscan.extract_flanks(
                jnp.asarray(seq),
                _pad(gaps["start"], -1), _pad(gaps["end"], -1),
                _pad(scaf_begin, 0), _pad(scaf_end, 0),
                flank_len=cfg.flank_length, margin=cfg.flank_margin))

    table = dict(gaps)
    table["flank_left"] = left
    table["flank_right"] = right
    table["flank_left_len"] = left_len
    table["flank_right_len"] = right_len

    if ws is not None:
        from ..parallel import mp
        ws.save_arrays("gaps", **table)
        ws.save_json("scaffold_names", genome.names)
        if mp.is_primary():
            _write_gap_positions(ws.path("gap_positions.txt"), table,
                                 genome)
            if write_parity_files:
                _write_flank_fastas(ws.path("flank_regions"), table)
        ws.mark_done("preprocess", config_hash(cfg), num_gaps=int(n))
    return table


def _write_gap_positions(path: str, table, genome: fasta.Genome) -> None:
    """Reference format: 'start end length scaffold_name' per line
    (gnrt_pos_true_seqs.py:54)."""
    with open(path, "w") as fh:
        for s, e, scaf in zip(table["local_start"], table["local_end"],
                              table["scaffold"]):
            fh.write(f"{s} {e} {e - s} {genome.names[scaf]}\n")


def _write_flank_fastas(folder: str, table) -> None:
    """Reference layout: flank_regions/<gap_id>.fa with two records
    '<gap_id>_left' / '<gap_id>_right' (gnrt_pos_true_seqs.py:89-99)."""
    os.makedirs(folder, exist_ok=True)
    ids = gap_ids(table)
    for i, gid in enumerate(ids):
        ll = int(table["flank_left_len"][i])
        rl = int(table["flank_right_len"][i])
        lseq = table["flank_left"][i][:ll]
        rseq = table["flank_right"][i][:rl]
        fasta.write_fasta(os.path.join(folder, f"{gid}.fa"),
                          [(f"{gid}_left", lseq), (f"{gid}_right", rseq)])
