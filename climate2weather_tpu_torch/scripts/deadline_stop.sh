#!/bin/bash
# The H100 port's deadline_stop.sh (the JAX repository's scripts/deadline_stop.sh), the same
# script: it starts no program of either package.
#
# Stop a recorded-PID run at a planned point: when a target path appears
# (e.g. the snapshot dir whose completion makes further training moot for
# this round) OR at a wall-clock deadline, whichever comes first.
#
# Never kills by name pattern (a rule of the repository): SIGTERMs the recorded PID
# only — the training supervisor forwards SIGTERM to its child group
# (tests/test_torch_supervisor.py), so the trainer checkpoints at the last
# completed 512Ki boundary and the always-on load_latest semantics stay
# intact. Downstream waiters (climate2weather_tpu_torch/scripts/h3_final_eval.sh) key off the PID
# exiting, so the unattended chain proceeds.
#
# Usage: deadline_stop.sh PIDFILE DEADLINE_EPOCH [TARGET_PATH]
set -u
PIDFILE=$1
DEADLINE=$2
TARGET=${3:-}

while true; do
  PID=$(cat "${PIDFILE}" 2>/dev/null || true)
  if [ -z "${PID}" ] || ! kill -0 "${PID}" 2>/dev/null; then
    echo "[deadline_stop] pid gone on its own at $(date -u +%FT%TZ)"
    exit 0
  fi
  if [ -n "${TARGET}" ] && [ -e "${TARGET}" ]; then
    echo "[deadline_stop] target ${TARGET} exists at $(date -u +%FT%TZ)"
    break
  fi
  if [ "$(date +%s)" -ge "${DEADLINE}" ]; then
    echo "[deadline_stop] deadline reached at $(date -u +%FT%TZ)"
    break
  fi
  sleep 20
done

echo "[deadline_stop] SIGTERM -> ${PID}"
kill "${PID}" 2>/dev/null || true
for _ in $(seq 1 60); do
  kill -0 "${PID}" 2>/dev/null || { echo "[deadline_stop] exited cleanly"; exit 0; }
  sleep 5
done
echo "[deadline_stop] still alive after 300s — SIGKILL ${PID}"
kill -9 "${PID}" 2>/dev/null || true
