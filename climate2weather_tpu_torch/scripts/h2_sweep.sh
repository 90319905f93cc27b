#!/bin/bash
# The H100 port's h2_sweep.sh (the JAX repository's scripts/h2_sweep.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H2 constrained sweep (docs/fidelity/meso128/H2_PREREG.md): exact-adjoint
# control points 100-104 and prolong points 200-204 over the pre-registered
# wind-gamma grid, sharing one unconditional control (feasibility floors).
# Window 2014-02-01-00 (disjoint from the gating window) per the prereg.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h2_sweep.sh \
#           > runs/sweep_meso128.log 2>&1 & echo $! > /tmp/sweep.pid
set -eu
# the repository's root, two levels above this script (the immutable copy
# under runs/ is handed it)
REPO=${C2W_REPO:-$(cd "$(dirname "$0")/../.." && pwd)}
SELF=$(cd "$(dirname "$0")" && pwd)/$(basename "$0")
cd "$REPO"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# immutable-copy prologue (docs/OPS.md failure taxonomy: never let an
# in-flight edit change or skip a step of a long runner)
if [ -z "${C2W_IMMUTABLE_COPY:-}" ]; then
  mkdir -p runs
  cp "$SELF" "runs/$(basename "$0").running.$$"
  C2W_REPO="$REPO" C2W_IMMUTABLE_COPY=1 exec bash "runs/$(basename "$0").running.$$" "$@"
fi

CFG=exp/configs/000_on-model-eval/meso128_sweep_base.yml
OUT=runs/sweep_meso128
S=0.1692666615037876,0.0425178630338289,0.3268027589410125,0.3268027589410125
GFIX=0.0007196856730011522
POINTS=()
for g in 0.0002 0.0007196856730011522 0.002 0.005 0.015; do
  POINTS+=(--point "$S,$GFIX,$GFIX,$g,$g")
done

echo "[h2_sweep] adjoint control points (100+) at $(date -u +%FT%TZ)"
python -m climate2weather_tpu_torch.scripts.likelihood_sweep --out "$OUT" --config "$CFG" \
  --num-samples 8 --point-base 100 "${POINTS[@]}" \
  --uncond --uncond-samples 8 --gate-vars uas,vas
echo "[h2_sweep] prolong points (200+) at $(date -u +%FT%TZ)"
python -m climate2weather_tpu_torch.scripts.likelihood_sweep --out "$OUT" --config "$CFG" \
  --num-samples 8 --point-base 200 "${POINTS[@]}" --guidance-prolong \
  --uncond --uncond-samples 8 --gate-vars uas,vas
echo "[h2_sweep] DONE at $(date -u +%FT%TZ); ranking in $OUT/RANKING.md"
