#!/bin/bash
# Day-one real-data runbook: one command from a raw
# Harvard-FairVision/GAMMA tree to a restart-safe 5-fold training queue.
#
#   DATA=/data/gamma LABELS=/data/train_true.xlsx bash scripts/run_harvard.sh
#
# Steps:
#   1. PREFLIGHT — scripts/verify_dataset.py validates the label join, path
#      patterns, NIfTI headers, OCT slice order BEFORE the full-model
#      compile; any error aborts the queue with actionable messages.
#   2. CACHE BUILD — scripts/build_cache.py decodes+resizes every sample
#      once into uint8 npz caches (host-only; first epoch then streams at
#      ~480 pairs/s instead of decode speed).
#   3. 5-FOLD QUEUE — python -m edrl.cli.train per fold (KFold seed 10
#      parity, fusion_train.py:564), each run --resume-ing from its rolling
#      `latest` checkpoint, deadline-file guarded like every queue in this repo
#      (write epoch-seconds to $DEADLINE_FILE to stop cleanly).
#
# Env knobs: DATASET (dr2), EPOCHS (200), BATCH (16), SCAN (16),
#   FOLDS ("0 1 2 3 4"), OUT_ROOT (results/harvard), RUN_TIMEOUT (43200 s/fold),
#   DEADLINE_FILE (results/study_deadline), EXTRA_ARGS (passed to cli.train),
#   SKIP_TRAIN=1 (preflight+cache only — used by the dress-rehearsal test).
set -u
cd "$(dirname "$0")/.."
: "${DATA:?set DATA=/path/to/tree}"
: "${LABELS:?set LABELS=/path/to/labels.(xlsx|csv)}"
DATASET="${DATASET:-dr2}"
EPOCHS="${EPOCHS:-200}"
BATCH="${BATCH:-16}"
SCAN="${SCAN:-16}"
FOLDS="${FOLDS:-0 1 2 3 4}"
OUT_ROOT="${OUT_ROOT:-results/harvard}"
RUN_TIMEOUT="${RUN_TIMEOUT:-43200}"
DEADLINE_FILE="${DEADLINE_FILE:-results/study_deadline}"
EXTRA_ARGS="${EXTRA_ARGS:-}"
mkdir -p "$OUT_ROOT"

past_deadline() {
  [ -f "$DEADLINE_FILE" ] || return 1
  local d now
  d=$(cat "$DEADLINE_FILE" 2>/dev/null) || return 1
  now=$(date +%s)
  [ -n "$d" ] && [ "$now" -ge "$d" ]
}

guard() {
  if past_deadline; then
    echo "--- deadline ($(cat "$DEADLINE_FILE")) passed; stopping cleanly ---"
    echo "--- re-run the same command to resume (folds resume from latest) ---"
    exit 3
  fi
}

echo "=== [1/3] preflight: $DATA ==="
python scripts/verify_dataset.py --dataset "$DATASET" \
  --data_path "$DATA" --label_file "$LABELS" || {
  echo "preflight FAILED — fix the reported samples, then re-run"; exit 1; }

echo "=== [2/3] uint8 cache build ==="
python scripts/build_cache.py --data_path "$DATA" --label_file "$LABELS" \
  || { echo "cache build FAILED"; exit 1; }

if [ "${SKIP_TRAIN:-0}" = "1" ]; then
  echo "=== SKIP_TRAIN=1: stopping after preflight + cache build ==="
  exit 0
fi

echo "=== [3/3] 5-fold training queue (resumable) ==="
for f in $FOLDS; do
  guard
  echo "--- fold $f -> $OUT_ROOT/ckpt_fold$f ---"
  timeout "$RUN_TIMEOUT" python -m edrl.cli.train \
    --dataset "$DATASET" --data_path "$DATA" --label_file "$LABELS" \
    --folder "folder$f" --batch_size "$BATCH" --end_epochs "$EPOCHS" \
    --scan_batches "$SCAN" --resume --save_latest_every 1 \
    --checkpoint_dir "$OUT_ROOT/ckpt_fold$f" --log_dir "$OUT_ROOT/log" \
    --name "harvard_f$f" $EXTRA_ARGS || {
      rc=$?
      # timeout(124)/preemption: the fold resumes on the next invocation.
      echo "(fold $f exited rc=$rc — resumable; continuing queue)"
    }
done
echo "=== runbook complete: checkpoints in $OUT_ROOT/ckpt_fold*, logs in $OUT_ROOT/log ==="
