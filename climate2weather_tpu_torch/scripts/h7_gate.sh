#!/bin/bash
# The H100 port's h7_gate.sh (the JAX repository's scripts/h7_gate.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H7 gate (docs/fidelity/meso128/H7_PREREG.md): the two registered
# calibration points (A: guidance-off + climatological spectral
# calibration + t=0 projection; B: COSMO guidance + the same) on the
# ARCHIVED 9.44Mi snapshot, frozen H1 window, 24 treated + 8 uncond each,
# followed by the REQUIRED band diagnostic and the mechanical composer.
# Runs concurrently with the extension trainer (deterministic function of
# the archived snapshot and seed; measured-safe working set — H4/H6 class).
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h7_gate.sh \
#           > runs/h7_gate.log 2>&1 & echo $! > /tmp/h7_gate.pid
set -u
# the repository's root, two levels above this script (the immutable copy
# under runs/ is handed it)
REPO=${C2W_REPO:-$(cd "$(dirname "$0")/../.." && pwd)}
SELF=$(cd "$(dirname "$0")" && pwd)/$(basename "$0")
cd "$REPO"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# immutable-copy prologue (docs/OPS.md failure taxonomy)
if [ -z "${C2W_IMMUTABLE_COPY:-}" ]; then
  mkdir -p runs
  cp "$SELF" "runs/$(basename "$0").running.$$"
  C2W_REPO="$REPO" C2W_IMMUTABLE_COPY=1 exec bash "runs/$(basename "$0").running.$$" "$@"
fi

echo "[h7] waiting for runs/h7_go"
while [ ! -f runs/h7_go ]; do sleep 30; done
echo "[h7] go at $(date -u +%FT%TZ)"

SNAP=artifacts/network-snapshot-0009437-0.999900
common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --start-time 2014-01-07-00
  --num-samples 24 --uncond-samples 8 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6
  --spectral-calibrate runs/synth_meso128/train_normed.h5
  --t0-project spectral --t0-project-iters 3)

echo "[h7] point A: calibration + projection, guidance off"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-off --out runs/h7_eval_calib
echo "[h7] point A rc=$?"

echo "[h7] point B: COSMO guidance + calibration + projection"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --out runs/h7_eval_gcalib
echo "[h7] point B rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands runs/h7_eval_calib runs/h7_eval_gcalib \
  > runs/h7_bands.md 2>&1
echo "[h7] band diagnostic rc=$?"

python "$REPO/scripts/h7_verdict.py" \
  --point-a runs/h7_eval_calib --point-b runs/h7_eval_gcalib \
  --bands runs/h7_bands.md
echo "[h7] verdict composer rc=$?"

touch runs/h7_gate.DONE
echo "[h7] DONE $(date -u +%FT%TZ)"
