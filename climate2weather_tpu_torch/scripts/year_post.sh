#!/bin/bash
# The H100 port's year_post.sh (the JAX repository's scripts/year_post.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# Post-processing for the year-2014 production run (VERDICT r4 next-step 4):
# runs the port's fast test tier (the round's serialization window — never
# concurrently with chip work), then year-scale metrics at the
# pre-declared stride-4 protocol (every 24 h, 365 frames), then the figure
# set. All CPU-heavy; the chip is idle between the year run and the sweep.
set -eu
# the repository's root, two levels above this script (the immutable copy
# under runs/ is handed it)
REPO=${C2W_REPO:-$(cd "$(dirname "$0")/../.." && pwd)}
SELF=$(cd "$(dirname "$0")" && pwd)/$(basename "$0")
cd "$REPO"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

if [ -z "${C2W_IMMUTABLE_COPY:-}" ]; then
  mkdir -p runs
  cp "$SELF" "runs/$(basename "$0").running.$$"
  C2W_REPO="$REPO" C2W_IMMUTABLE_COPY=1 exec bash "runs/$(basename "$0").running.$$" "$@"
fi

EXP=runs/year2014_meso128/001_year2014_meso128_dpm64

echo "[year_post] fast test tier at $(date -u +%FT%TZ)"
python -m pytest tests/test_torch_*.py -q -m "not slow" 2>&1 | tail -3

# (the JAX script's next step, the __graft_entry__.py multi-chip dry run, is
# a hook of the TPU driver with no counterpart here, so it is left out)

echo "[year_post] year metrics (time-stride 4) at $(date -u +%FT%TZ)"
python -m climate2weather_tpu_torch.experiment metrics run "$EXP" --time-stride 4

echo "[year_post] figures at $(date -u +%FT%TZ)"
for kind in rapsd calibration kde_and_pmf climate_grid timeseries windpower_dist; do
  python -m climate2weather_tpu_torch.experiment figures "$kind" "$EXP" \
    || echo "[year_post] figure $kind failed (non-blocking)"
done
echo "[year_post] DONE at $(date -u +%FT%TZ)"
