#!/bin/bash
# The H100 port's year_winning.sh (the JAX repository's scripts/year_winning.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# Full-year 2014 at the WINNING pipeline setting (H8 point C / H9):
# guidance + DPM++(2M)-64 SDE eta=0.3 + climatological calibration + t=0
# projection through the NCHW long sampler — the north-star workload at
# the first setting that passes the H1 wind criteria.  Protocol frozen in
# exp/configs/001_clim-downscaling/year2014_meso128_winning.yml (committed
# before launch).  Chip-exclusive (~2.4 h sampling), then CPU metrics at
# the pre-declared stride-4 protocol (matching YEAR2014.md) and figures.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/year_winning.sh \
#           > runs/year_winning.log 2>&1 & echo $! > /tmp/year_winning.pid
set -u
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

# hard-fail before burning chip time: the year eval grid is regenerable
# (synthesize_cosmo_like(8760, res=128, seed=1, spectrum='mesoscale') — it
# was lost once to a VM recycle) but predict must never start without it
if [ ! -f runs/synth_meso128/eval_year.nc ]; then
  echo "[year_winning] FATAL: runs/synth_meso128/eval_year.nc missing"
  exit 1
fi

echo "[year_winning] predict start $(date -u +%FT%TZ)"
python -m climate2weather_tpu_torch.experiment predict \
  --save-path runs/year2014_winning \
  --config-path exp/configs/001_clim-downscaling/year2014_meso128_winning.yml
rc=$?
echo "[year_winning] predict rc=${rc} at $(date -u +%FT%TZ)"
if [ "${rc}" -ne 0 ]; then
  # abort the chain: metrics/figures on a missing ensemble would bury the
  # real failure under their own tracebacks (observed 2026-08-20)
  echo "[year_winning] FATAL: predict failed; aborting before metrics"
  exit "${rc}"
fi

EXP=$(ls -d runs/year2014_winning/*year2014_meso128_winning* | head -1)
echo "[year_winning] exp dir: ${EXP}"

echo "[year_winning] year metrics (time-stride 4) at $(date -u +%FT%TZ)"
python -m climate2weather_tpu_torch.experiment metrics run "${EXP}" --time-stride 4
echo "[year_winning] metrics rc=$?"

echo "[year_winning] figures at $(date -u +%FT%TZ)"
for kind in rapsd calibration kde_and_pmf climate_grid timeseries windpower_dist; do
  python -m climate2weather_tpu_torch.experiment figures "$kind" "${EXP}" \
    || echo "[year_winning] figure $kind failed (non-blocking)"
done

touch runs/year_winning.DONE
echo "[year_winning] DONE at $(date -u +%FT%TZ)"
