#!/bin/bash
# The H100 port's h9_gate.sh (the JAX repository's scripts/h9_gate.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H9 gate (docs/fidelity/meso128/H9_PREREG.md): confirmatory replication
# of H8 point C — the full pipeline (COSMO guidance + DPM++(2M)-64 SDE
# eta=0.3 + denoise-final + climatological calibration + t=0 spectral
# projection) on a HELD-OUT window (2014-02-15-00) with a FRESH seed (1).
# Point A gates; point B (H1 window, seed 1) separates seed from window.
# Archived 9.44Mi snapshot, 24 treated + 8 uncond each, REQUIRED band
# diagnostic + amplitude instrument, mechanical composer.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h9_gate.sh \
#           > runs/h9_gate.log 2>&1 & echo $! > /tmp/h9_gate.pid
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

echo "[h9] start $(date -u +%FT%TZ)"

SNAP=artifacts/network-snapshot-0009437-0.999900
common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --num-samples 24 --uncond-samples 8 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6
  --sde-eta 0.3 --seed 1
  --t0-project spectral --t0-project-iters 3
  --spectral-calibrate runs/synth_meso128/train_normed.h5)

echo "[h9] point A: held-out window 2014-02-15-00, seed 1 (gating)"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --start-time 2014-02-15-00 --out runs/h9_eval_heldout
echo "[h9] point A rc=$?"

echo "[h9] point B: H1 window 2014-01-07-00, seed 1 (seed-robustness)"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --start-time 2014-01-07-00 --out runs/h9_eval_h1window
echo "[h9] point B rc=$?"

python -m climate2weather_tpu_torch.scripts.amplitude_ratio \
  runs/h9_eval_heldout/guided/001_config \
  runs/h9_eval_h1window/guided/001_config \
  --out runs/h9_amplitude.md
echo "[h9] amplitude instrument rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands \
  runs/h9_eval_heldout runs/h9_eval_h1window \
  > runs/h9_bands.md 2>&1
echo "[h9] band diagnostic rc=$?"

python "$REPO/scripts/h9_verdict.py" \
  --point-a runs/h9_eval_heldout \
  --point-b runs/h9_eval_h1window \
  --amplitude runs/h9_amplitude.md \
  --amp-a-key runs/h9_eval_heldout/guided/001_config \
  --amp-b-key runs/h9_eval_h1window/guided/001_config \
  --bands runs/h9_bands.md
echo "[h9] verdict composer rc=$?"

touch runs/h9_gate.DONE
echo "[h9] DONE $(date -u +%FT%TZ)"
