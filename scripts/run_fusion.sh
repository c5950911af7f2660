#!/usr/bin/env bash
# Launch-layer parity with the reference's ``code/Run_fusion.sh``
# (SURVEY.md section 2.6).  The reference passed --model_name "IMDR", which
# matched no factory branch (defect ledger #11); here IMDR is a registered
# alias of MedFusion, so the flag works as shipped.
#
# Point --data_path/--label_file at a GAMMA-layout dataset, or leave the
# default synthetic dataset for a hermetic run.
set -euo pipefail
cd "$(dirname "$0")/.."

python -m edrl.cli.train \
    --model_name "IMDR" \
    --dataset "${DATASET:-synthetic}" \
    --mode "train&test" \
    --folder folder0 \
    --lr 1e-5 \
    --batch_size 32 \
    --end_epochs 200 \
    --Condition_G_Variance "${NOISE:-0.5}" \
    "$@"
