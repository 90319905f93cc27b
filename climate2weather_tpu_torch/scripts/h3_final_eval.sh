#!/bin/bash
# The H100 port's h3_final_eval.sh (the JAX repository's scripts/h3_final_eval.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# Unattended H3 final eval (docs/fidelity/meso128/H3_PREREG.md): waits for
# the extension trainer to exit, quiesces the probe watcher, then runs ONE
# eval row (24 guided COSMO-hparams + 24 unconditional samples, DPM-64 +
# denoise-final, 49 h from 2014-01-07-00) on the HIGHEST completed
# 0.9999-EMA snapshot (13631Ki if the run completed; the last 512Ki
# checkpoint's snapshot under the prereg's shortfall clause otherwise),
# followed by the REQUIRED band diagnostic and the mechanical H3 verdict.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h3_final_eval.sh \
#           > runs/h3_final_eval.log 2>&1 & echo $! > /tmp/h3_eval.pid
set -u
# the repository's root, two levels above this script (the immutable copy
# under runs/ is handed it)
REPO=${C2W_REPO:-$(cd "$(dirname "$0")/../.." && pwd)}
SELF=$(cd "$(dirname "$0")" && pwd)/$(basename "$0")
cd "$REPO"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# Execute an immutable copy (docs/OPS.md failure taxonomy: editing an
# in-flight bash script silently changes/skips unreached steps).
if [ -z "${C2W_IMMUTABLE_COPY:-}" ]; then
  mkdir -p runs
  cp "$SELF" "runs/$(basename "$0").running.$$"
  C2W_REPO="$REPO" C2W_IMMUTABLE_COPY=1 exec bash "runs/$(basename "$0").running.$$" "$@"
fi

# Wait for the trainer/supervisor to exit (the supervisor relaunches wedged
# trainers under the same PID, so PID-exit means the run is truly over).
echo "[h3_eval] waiting for trainer (pid $(cat /tmp/train.pid 2>/dev/null || echo '?')) to exit"
while TRAIN_PID=$(cat /tmp/train.pid 2>/dev/null) \
      && [ -n "${TRAIN_PID}" ] && kill -0 "${TRAIN_PID}" 2>/dev/null; do
  sleep 60
done
echo "[h3_eval] trainer exited at $(date -u +%FT%TZ)"

# Highest completed 0.9999-EMA snapshot.
SNAP=$(ls -d runs/meso128/network-snapshot-*-0.999900 2>/dev/null | sort | tail -1)
if [ -z "${SNAP}" ]; then
  echo "[h3_eval] FATAL: no 0.9999 snapshot in runs/meso128"
  exit 1
fi
KDATA=$(basename "${SNAP}" | sed -E 's/network-snapshot-0*([0-9]+)-.*/\1/')
echo "[h3_eval] snapshot: ${SNAP} (kdata ${KDATA})"
if [ "${KDATA}" -le 9437 ]; then
  echo "[h3_eval] FATAL: no extension snapshot beyond 9437Ki — nothing to judge"
  exit 1
fi

# Quiesce the probe watcher (log quiet >= 20 min, then recorded-PID kill).
PROBE_PID=$(cat /tmp/probe.pid 2>/dev/null || true)
if [ -n "${PROBE_PID}" ] && kill -0 "${PROBE_PID}" 2>/dev/null; then
  while true; do
    age=$(( $(date +%s) - $(stat -c %Y runs/probe_meso128.log 2>/dev/null || echo 0) ))
    [ "${age}" -ge 1200 ] && break
    sleep 60
  done
  kill "${PROBE_PID}" 2>/dev/null || true
  echo "[h3_eval] probe watcher stopped"
fi

echo "[h3_eval] eval row: COSMO hparams, 24 guided + 24 uncond"
python -m climate2weather_tpu_torch.exp.fidelity \
  --snapshot "${SNAP}" \
  --data-nc runs/synth_meso128/eval_merged.nc \
  --quantiles runs/synth_meso128/quantiles.h5 \
  --start-time 2014-01-07-00 \
  --num-samples 24 --uncond-samples 24 --num-sampling-steps 64 \
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6 \
  --out runs/h3_eval_cosmo
echo "[h3_eval] eval rc=$?"

python -m climate2weather_tpu_torch.scripts.progression_report runs/probe_meso128 \
  > runs/h3_progression.txt 2>&1
echo "[h3_eval] progression rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands runs/h3_eval_cosmo \
  > runs/h3_bands.md 2>&1
echo "[h3_eval] band diagnostic rc=$?"

python "$REPO/scripts/h3_verdict.py" \
  --eval-dir runs/h3_eval_cosmo --bands runs/h3_bands.md \
  --progression runs/h3_progression.txt --snapshot-kdata "${KDATA}"
echo "[h3_eval] verdict composer rc=$?"

touch runs/h3_eval.DONE
echo "[h3_eval] DONE $(date -u +%FT%TZ)"
