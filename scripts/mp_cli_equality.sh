#!/bin/bash
# Shipped-CLI multi-process bit-equality at workload scale (VERDICT r3
# next #5b): run `-c All` at 1, 4 and 8 processes (gloo, CPU backend,
# 8 global devices) on the same dataset and byte-compare every output.
# Usage: scripts/mp_cli_equality.sh [data_dir]   (default /tmp/stress480,
# produced by: python scripts/stress_pipeline.py 480 30 --dir=DIR --sim-only)
set -e
cd "$(dirname "$0")/.."
D=${1:-/tmp/stress480}
for np in 1 4 8; do
  python - <<PYEOF
import json
cfg = {
    "draft_genome": {"fa": "$D/draft.fa"},
    "alignments": [{"bam": "$D/lib.bam", "is": 300, "std": 30}],
    "raw_reads": [{"left": "$D/l.fq", "right": "$D/r.fq"}],
    "kmer_length": [{"k": 25, "k_velvet": [{"k": 21}]},
                    {"k": 31, "k_velvet": [{"k": 27}]}],
    "parameters": {"working_folder": "$D/work_mp$np", "min_gap_size": 50,
                   "flank_length": 150, "nthreads": 1, "verbose": 0},
    "device": {"mesh_shape": [8], "gap_batch": 32},
}
open("$D/cfg_mp$np.json", "w").write(json.dumps(cfg).replace("False", "false"))
PYEOF
done
rm -rf $D/work_mp1 $D/work_mp4 $D/work_mp8
echo "== 1 proc =="
time python -m gappadder.cli -c All -g $D/cfg_mp1.json --coordinator 127.0.0.1:29811 --num-processes 1 --process-id 0 --cpu-devices 8 > /tmp/mp480_1.log 2>&1
for np in 4 8; do
  echo "== $np proc =="
  port=$((29820 + np))
  pids=()
  for pid in $(seq 0 $((np - 1))); do
    python -m gappadder.cli -c All -g $D/cfg_mp$np.json \
      --coordinator 127.0.0.1:$port --num-processes $np \
      --process-id $pid --cpu-devices $((8 / np)) \
      > /tmp/mp480_${np}_$pid.log 2>&1 &
    pids+=($!)
  done
  rc=0
  for p in "${pids[@]}"; do wait $p || rc=1; done
  [ $rc -eq 0 ] || { echo "$np-proc FAILED"; exit 1; }
done
for np in 4 8; do
  for f in picked_seqs.fa picked_seqs.fa_ori.txt gap_positions.txt merge_info.txt; do
    cmp $D/work_mp1/$f $D/work_mp$np/$f && echo "OK $np-proc $f" || { echo "DIFF $np-proc $f"; exit 1; }
  done
done
echo ALL-BIT-EQUAL
