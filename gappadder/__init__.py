"""gappadder: genome gap-closing framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
simoncchu/GAPPadder (see SURVEY.md): locate N-run gaps in draft-genome
scaffolds, recruit gap-related reads (clipped / discordant / low-mapq /
unmapped-mate), assemble each gap's reads with a multi-k de-Bruijn
pipeline, merge + dedup contigs with an overlap-graph engine, pick the
contig anchored by both flanks, and patch it back into the scaffold.

Layers (bottom-up; mirrors SURVEY.md §7):
  ops/       L0/L2 device kernels & batched ops (gap scan, k-mers, SW,
             overlap DP, DBG assembly, dedup, pick, coverage)
  io/        L1 host I/O: FASTA/FASTQ/BAM -> columnar numpy arrays
  parallel/  mesh + sharding + collectives
  pipeline/  L3 stages: preprocess, collect, assemble, pick, patch
  cli.py     L4 CLI + JSON config (reference-compatible schema)
"""

__version__ = "0.1.0"
