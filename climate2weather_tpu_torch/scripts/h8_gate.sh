#!/bin/bash
# The H100 port's h8_gate.sh (the JAX repository's scripts/h8_gate.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H8 gate (docs/fidelity/meso128/H8_PREREG.md): amplitude attribution —
# point A: unconditional SDE η=0.3 (gating, amplitude-ratio instrument vs
# the SAVED deterministic control); point B: COSMO guidance + SDE +
# projection (no calibration); point C: the H7 pipeline on the SDE solver.
# Archived 9.44Mi snapshot, frozen H1 window, 24 treated + 8 uncond each,
# REQUIRED band diagnostic, mechanical composer.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h8_gate.sh \
#           > runs/h8_gate.log 2>&1 & echo $! > /tmp/h8_gate.pid
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

echo "[h8] start $(date -u +%FT%TZ)"

SNAP=artifacts/network-snapshot-0009437-0.999900
CONTROL=runs/h7_eval_calib/uncond/001_config
common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --start-time 2014-01-07-00
  --num-samples 24 --uncond-samples 8 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6
  --sde-eta 0.3)

echo "[h8] point A: unconditional SDE eta=0.3"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-off --out runs/h8_eval_sde_uncond
echo "[h8] point A rc=$?"

echo "[h8] point B: COSMO guidance + SDE + projection"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --t0-project spectral --t0-project-iters 3 \
  --out runs/h8_eval_sde_gproj
echo "[h8] point B rc=$?"

echo "[h8] point C: COSMO guidance + SDE + calibration + projection"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --t0-project spectral --t0-project-iters 3 \
  --spectral-calibrate runs/synth_meso128/train_normed.h5 \
  --out runs/h8_eval_sde_gcalib
echo "[h8] point C rc=$?"

python -m climate2weather_tpu_torch.scripts.amplitude_ratio \
  runs/h8_eval_sde_uncond/guided/001_config \
  "${CONTROL}" \
  runs/h8_eval_sde_gproj/guided/001_config \
  runs/h8_eval_sde_gcalib/guided/001_config \
  --out runs/h8_amplitude.md
echo "[h8] amplitude instrument rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands \
  runs/h8_eval_sde_uncond runs/h8_eval_sde_gproj runs/h8_eval_sde_gcalib \
  > runs/h8_bands.md 2>&1
echo "[h8] band diagnostic rc=$?"

python "$REPO/scripts/h8_verdict.py" \
  --amplitude runs/h8_amplitude.md \
  --treated-key runs/h8_eval_sde_uncond/guided/001_config \
  --control-key "${CONTROL}" \
  --point-a runs/h8_eval_sde_uncond \
  --point-b runs/h8_eval_sde_gproj --amp-b-key runs/h8_eval_sde_gproj/guided/001_config \
  --point-c runs/h8_eval_sde_gcalib --amp-c-key runs/h8_eval_sde_gcalib/guided/001_config \
  --bands runs/h8_bands.md
echo "[h8] verdict composer rc=$?"

touch runs/h8_gate.DONE
echo "[h8] DONE $(date -u +%FT%TZ)"
