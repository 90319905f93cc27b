#!/bin/bash
# The H100 port's meso128_final_eval.sh (the JAX repository's scripts/meso128_final_eval.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# Waits for the meso128 production trainer to reach 9Mi and exit, then runs
# the pre-registered final eval (docs/fidelity/meso128/PREREG.md + RESUME.md):
# three rows on network-snapshot-0009437-0.999900, 24 guided + 24
# unconditional samples each, 49 h from 2014-01-07-00, DPM-64 + denoise-final.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/meso128_final_eval.sh \
#           > runs/meso128_final_eval.log 2>&1 & echo $! > /tmp/final_eval.pid
set -u
# the repository's root, two levels above this script (the immutable copy
# under runs/ is handed it)
REPO=${C2W_REPO:-$(cd "$(dirname "$0")/../.." && pwd)}
SELF=$(cd "$(dirname "$0")" && pwd)/$(basename "$0")
cd "$REPO"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# Execute an IMMUTABLE COPY of this script: bash reads scripts lazily, so
# editing an in-flight runner changes (or silently skips) steps it has not
# reached yet — exactly how the round-4 band-diagnostic step never ran
# (VERDICT r4 weak-item 2; docs/OPS.md failure taxonomy). The copy is
# stamped with the PID and left in runs/ as part of the run record.
if [ -z "${C2W_IMMUTABLE_COPY:-}" ]; then
  mkdir -p runs
  cp "$SELF" "runs/$(basename "$0").running.$$"
  C2W_REPO="$REPO" C2W_IMMUTABLE_COPY=1 exec bash "runs/$(basename "$0").running.$$" "$@"
fi

SNAP=runs/meso128/network-snapshot-0009437-0.999900

# Poll for the final snapshot itself rather than a one-time PID read: the
# supervisor can be relaunched (VM restart) under a new PID mid-run, which
# orphaned the first incarnation of this waiter. Re-read /tmp/train.pid each
# minute purely to warn when nothing is training AND the snapshot is absent.
echo "[final_eval] waiting for ${SNAP}"
warned=0
while [ ! -d "${SNAP}" ]; do
  TRAIN_PID=$(cat /tmp/train.pid 2>/dev/null || true)
  if [ -n "${TRAIN_PID}" ] && kill -0 "${TRAIN_PID}" 2>/dev/null; then
    warned=0
  elif [ "${warned}" -eq 0 ]; then
    echo "[final_eval] WARN: no live trainer (pid ${TRAIN_PID:-?}) and ${SNAP} missing at $(date -u +%FT%TZ); waiting for an operator relaunch"
    warned=1
  fi
  sleep 60
done
echo "[final_eval] snapshot present at $(date -u +%FT%TZ)"

# Now wait for the trainer/supervisor to actually exit so the evals get the
# chip (the final checkpoint save trails the final snapshot by a few ticks).
while TRAIN_PID=$(cat /tmp/train.pid 2>/dev/null) \
      && [ -n "${TRAIN_PID}" ] && kill -0 "${TRAIN_PID}" 2>/dev/null; do
  sleep 60
done
echo "[final_eval] trainer exited at $(date -u +%FT%TZ)"

# Let any in-flight probe finish (probe log quiet 20 min - compiles can be
# silent ~9 min, so a short window would false-positive), then stop the
# watcher by its recorded PID so the evals get a quiet chip.
PROBE_PID=$(cat /tmp/probe.pid 2>/dev/null || true)
if [ -n "${PROBE_PID}" ] && kill -0 "${PROBE_PID}" 2>/dev/null; then
  while true; do
    age=$(( $(date +%s) - $(stat -c %Y runs/probe_meso128.log 2>/dev/null || echo 0) ))
    [ "${age}" -ge 1200 ] && break
    sleep 60
  done
  kill "${PROBE_PID}" 2>/dev/null || true
  echo "[final_eval] probe watcher stopped"
fi

common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --start-time 2014-01-07-00
  --num-samples 24 --uncond-samples 24 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6)
tuned=(--likelihood-gamma 0.003 --likelihood-gamma 0.003
  --likelihood-gamma 0.04 --likelihood-gamma 0.01)

echo "[final_eval] row 1/3: COSMO hparams (gating)"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --out runs/meso128_eval_cosmo
echo "[final_eval] row 1 rc=$?"

echo "[final_eval] row 2/3: tuned per-channel gamma (gating)"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" "${tuned[@]}" \
  --out runs/meso128_eval_tuned
echo "[final_eval] row 2 rc=$?"

echo "[final_eval] row 3/3: tuned gamma + sde-eta 0.3 (non-gating)"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" "${tuned[@]}" \
  --sde-eta 0.3 --out runs/meso128_eval_tuned_sde03
echo "[final_eval] row 3 rc=$?"

python -m climate2weather_tpu_torch.scripts.progression_report runs/probe_meso128 \
  > runs/meso128_progression.txt 2>&1
echo "[final_eval] progression report rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands \
  runs/meso128_eval_cosmo runs/meso128_eval_tuned runs/meso128_eval_tuned_sde03 \
  > runs/meso128_bands.md 2>&1
echo "[final_eval] band diagnostic rc=$?"

python "$REPO/scripts/meso128_verdict.py" \
  --cosmo runs/meso128_eval_cosmo --tuned runs/meso128_eval_tuned \
  --sde runs/meso128_eval_tuned_sde03 \
  --progression runs/meso128_progression.txt \
  --bands runs/meso128_bands.md
echo "[final_eval] verdict composer rc=$?"

touch runs/meso128_eval.DONE
echo "[final_eval] DONE $(date -u +%FT%TZ)"
