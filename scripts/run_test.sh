#!/usr/bin/env bash
# Launch-layer parity with the reference's ``Run_test.sh``
# (SURVEY.md section 2.6): evaluation from a checkpoint.
set -euo pipefail
cd "$(dirname "$0")/.."

python -m edrl.cli.test \
    --model_name "IMDR" \
    --dataset "${DATASET:-synthetic}" \
    --folder folder0 \
    --batch_size 32 \
    --Condition_G_Variance "${NOISE:-0.5}" \
    --checkpoint "${CHECKPOINT:-}" \
    "$@"
