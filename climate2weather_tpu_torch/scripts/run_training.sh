#!/bin/bash
# Production training launch on the card (port of the JAX repository's
# run_training.sh; reference run_training.sh:32-48 hyperparameters).
#
# The run is wrapped in the stall supervisor
# (climate2weather_tpu_torch/training/supervisor.py): if the trainer prints
# nothing for --stall-timeout, its process group is killed and relaunched,
# and the trainer's always-on load_latest resume continues the run bit for
# bit (scripts/soak_training.py). Set C2W_NO_SUPERVISOR=1 to launch the bare
# trainer (e.g. under SLURM requeueing, which plays the same role). Under
# torchrun, put the launcher in front of `-m climate2weather_tpu_torch.train`
# by hand; this script starts one process.
#
# Usage: climate2weather_tpu_torch/scripts/run_training.sh RUN_DIR RUN_ID TRAIN_H5 [extra train flags...]
set -euo pipefail

RUN_DIR=${1:?usage: run_training.sh RUN_DIR RUN_ID TRAIN_H5 [flags...]}
RUN_ID=${2:?}
TRAIN_H5=${3:?}
shift 3

REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python}

LAUNCH=("$PYTHON" -m climate2weather_tpu_torch.train)
if [ -z "${C2W_NO_SUPERVISOR:-}" ]; then
  mkdir -p "$RUN_DIR/$RUN_ID"
  LAUNCH=("$PYTHON" -m climate2weather_tpu_torch.training.supervisor
    --stall-timeout 900 --max-restarts 8
    --steady-pattern 'Status:'
    --journal "$RUN_DIR/$RUN_ID/supervisor.jsonl"
    -- "$PYTHON" -m climate2weather_tpu_torch.train)
fi

exec "${LAUNCH[@]}" \
  --run-dir "$RUN_DIR" \
  --run-id "$RUN_ID" \
  --train-data "$TRAIN_H5" \
  --spatial-res 128 \
  --num-features 4 \
  --markov-order 6 \
  --cache-data \
  --total-ndata 180Mi \
  --batch 512 \
  --batch-gpu 128 \
  --lr 0.0001 \
  --status 20Ki \
  --snapshot 1Mi \
  --checkpoint 2Mi \
  --logging 5Ki \
  --valid 1Mi \
  --seed 42 \
  "$@"
