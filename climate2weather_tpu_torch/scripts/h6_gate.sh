#!/bin/bash
# The H100 port's h6_gate.sh (the JAX repository's scripts/h6_gate.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H6 gate (docs/fidelity/meso128/H6_PREREG.md): the two registered
# t=0-projection points (A: guidance-off + spectral projection; B: 0.1x
# COSMO gamma + spectral projection) on the ARCHIVED 9.44Mi snapshot,
# frozen H1 window, 24 projected + 8 uncond each, followed by the REQUIRED
# band diagnostic and the mechanical composer. Runs concurrently with the
# extension trainer (deterministic function of the archived snapshot and
# seed; measured-safe working set — same class as H4).
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h6_gate.sh \
#           > runs/h6_gate.log 2>&1 & echo $! > /tmp/h6_gate.pid
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

echo "[h6] waiting for runs/h6_go"
while [ ! -f runs/h6_go ]; do sleep 30; done
echo "[h6] go at $(date -u +%FT%TZ)"

SNAP=artifacts/network-snapshot-0009437-0.999900
common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --start-time 2014-01-07-00
  --num-samples 24 --uncond-samples 8 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6
  --t0-project spectral --t0-project-iters 3)

echo "[h6] point A: projection only (guidance off)"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-off --out runs/h6_eval_proj
echo "[h6] point A rc=$?"

echo "[h6] point B: 0.1x COSMO gamma + projection"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --likelihood-gamma 7.196856730011522e-5 --out runs/h6_eval_gproj
echo "[h6] point B rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands runs/h6_eval_proj runs/h6_eval_gproj \
  > runs/h6_bands.md 2>&1
echo "[h6] band diagnostic rc=$?"

python "$REPO/scripts/h6_verdict.py" \
  --point-a runs/h6_eval_proj --point-b runs/h6_eval_gproj \
  --bands runs/h6_bands.md
echo "[h6] verdict composer rc=$?"

touch runs/h6_gate.DONE
echo "[h6] DONE $(date -u +%FT%TZ)"
