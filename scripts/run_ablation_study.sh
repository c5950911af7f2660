#!/bin/bash
# Drive the ablation study one (variant, seed) per PROCESS: a single-process
# multi-run study leaks ~30 GB host RSS per full-size run (OOM-killed at
# 128 GB mid-study on 2026-08-17).  Each invocation resumes from the .jsonl
# (finished runs skip instantly) and re-renders ABLATION.md, so this loop is
# idempotent and restart-safe.
set -u
cd "$(dirname "$0")/.."
EPOCHS="${EPOCHS:-25}"
SEEDS="${SEEDS:-0 1 2}"
PROTOCOL="${PROTOCOL:-hard}"
# A cold compile cache pays a full-model compile on the first run of each
# distinct program; the budget is overridable.
RUN_TIMEOUT="${RUN_TIMEOUT:-5400}"
# Deadline guard: if DEADLINE_FILE holds an epoch-seconds timestamp, no NEW
# run starts after it (in-flight runs finish and their row still lands in the
# .jsonl).  Lets a detached multi-hour queue yield the card cleanly before
# something else needs it; the deadline can be moved by rewriting the file
# while the queue runs.
DEADLINE_FILE="${DEADLINE_FILE:-results/study_deadline}"
past_deadline() {
  [ -f "$DEADLINE_FILE" ] || return 1
  local d now
  d=$(cat "$DEADLINE_FILE" 2>/dev/null) || return 1
  now=$(date +%s)
  [ -n "$d" ] && [ "$now" -ge "$d" ]
}
for seed in $SEEDS; do
  for v in "MedFusion (full EDRL)" "MedFusion -MMD" "MedFusion -EPRL" \
           "MedFusion -DILR" "Multi_ResNet (late fusion)"; do
    if past_deadline; then
      echo "--- deadline ($(cat "$DEADLINE_FILE")) passed; stopping cleanly ---"
      exit 3
    fi
    echo "--- driving: $v s$seed ---"
    timeout "$RUN_TIMEOUT" python scripts/ablation_study.py \
      --epochs "$EPOCHS" --seeds "$seed" --variants "$v" \
      --protocol "$PROTOCOL" || exit 1
  done
done
