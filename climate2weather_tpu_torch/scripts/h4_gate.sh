#!/bin/bash
# The H100 port's h4_gate.sh (the JAX repository's scripts/h4_gate.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H4 gate (docs/fidelity/meso128/H4_PREREG.md): the two registered
# annealed-guidance points (t_rel 0.3 and 0.5, COSMO sigma/gamma) on the
# ARCHIVED 9.44Mi snapshot, frozen H1 window, 24 guided + 8 uncond each,
# followed by the REQUIRED band diagnostic and the mechanical composer.
# Chains after the H3 final eval so the chip is quiet.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h4_gate.sh \
#           > runs/h4_gate.log 2>&1 & echo $! > /tmp/h4_gate.pid
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

# Round-5 second-recycle reorder (H4_PREREG deviations log): H4 depends
# only on the ARCHIVED snapshot, so under clock pressure it runs
# concurrently with the H3 extension trainer (measured-safe working set,
# docs/OPS.md) instead of after the H3 eval. Gate on either marker.
echo "[h4] waiting for runs/h4_go or runs/h3_eval.DONE"
while [ ! -f runs/h4_go ] && [ ! -f runs/h3_eval.DONE ]; do sleep 30; done
echo "[h4] go at $(date -u +%FT%TZ)"

SNAP=artifacts/network-snapshot-0009437-0.999900
common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --start-time 2014-01-07-00
  --num-samples 24 --uncond-samples 8 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6)

echo "[h4] point A: t_rel=0.3"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-anneal 0.3 --out runs/h4_eval_trel03
echo "[h4] point A rc=$?"

echo "[h4] point B: t_rel=0.5"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-anneal 0.5 --out runs/h4_eval_trel05
echo "[h4] point B rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands runs/h4_eval_trel03 runs/h4_eval_trel05 \
  > runs/h4_bands.md 2>&1
echo "[h4] band diagnostic rc=$?"

python "$REPO/scripts/h4_verdict.py" \
  --point-a runs/h4_eval_trel03 --point-b runs/h4_eval_trel05 \
  --bands runs/h4_bands.md
echo "[h4] verdict composer rc=$?"

touch runs/h4_gate.DONE
echo "[h4] DONE $(date -u +%FT%TZ)"
