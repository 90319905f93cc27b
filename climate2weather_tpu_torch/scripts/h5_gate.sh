#!/bin/bash
# The H100 port's h5_gate.sh (the JAX repository's scripts/h5_gate.sh): the same
# steps, order, printed lines and exit codes, through the port's commands
# (python -m climate2weather_tpu_torch...); the text-only verdict composers
# stay the repository's scripts/*_verdict.py.
#
# H5 gate (docs/fidelity/meso128/H5_PREREG.md): the two registered
# annealed-guidance points (t_rel 0.3 and 0.5, COSMO sigma/gamma) on the
# EXTENDED H3 snapshot (highest completed 0.9999-EMA beyond 9437Ki),
# frozen H1 window, 24 guided + 8 uncond each, followed by the REQUIRED
# band diagnostic and the mechanical composer (whose unconditional bars
# come from the H3 final-eval table per the registered rule).
# Chains after the H4 gate so the chip is quiet.
#
# Launch: PYTHONUNBUFFERED=1 nohup ./climate2weather_tpu_torch/scripts/h5_gate.sh \
#           > runs/h5_gate.log 2>&1 & echo $! > /tmp/h5_gate.pid
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

# Round-5 second-recycle reorder: H4 now completes concurrently with the
# extension trainer, so the quiet-chip gate for H5 is BOTH the H4 marker
# and the H3 final eval (which itself waits for trainer exit).
echo "[h5] waiting for runs/h4_gate.DONE and runs/h3_eval.DONE"
while [ ! -f runs/h4_gate.DONE ] || [ ! -f runs/h3_eval.DONE ]; do sleep 30; done
echo "[h5] chip free at $(date -u +%FT%TZ)"

# Extended snapshot: highest completed 0.9999 EMA beyond the 9437Ki base.
SNAP=$(ls -d runs/meso128/network-snapshot-*-0.999900 2>/dev/null | sort | tail -1)
if [ -z "${SNAP}" ]; then
  echo "[h5] FATAL: no 0.9999 snapshot in runs/meso128"
  exit 1
fi
KDATA=$(basename "${SNAP}" | sed -E 's/network-snapshot-0*([0-9]+)-.*/\1/')
if [ "${KDATA}" -le 9437 ]; then
  echo "[h5] FATAL: no extension snapshot beyond 9437Ki"
  exit 1
fi
if [ ! -f runs/h3_eval_cosmo/FIDELITY.md ]; then
  echo "[h5] FATAL: runs/h3_eval_cosmo/FIDELITY.md (uncond-bar source) missing"
  exit 1
fi
echo "[h5] snapshot: ${SNAP} (kdata ${KDATA})"

common=(--snapshot "${SNAP}"
  --data-nc runs/synth_meso128/eval_merged.nc
  --quantiles runs/synth_meso128/quantiles.h5
  --start-time 2014-01-07-00
  --num-samples 24 --uncond-samples 8 --num-sampling-steps 64
  --sampler-kind dpmpp2m --denoise-final --ensemble-batch 6)

echo "[h5] point A: t_rel=0.3"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-anneal 0.3 --out runs/h5_eval_trel03
echo "[h5] point A rc=$?"

echo "[h5] point B: t_rel=0.5"
python -m climate2weather_tpu_torch.exp.fidelity "${common[@]}" \
  --guidance-anneal 0.5 --out runs/h5_eval_trel05
echo "[h5] point B rc=$?"

python -m climate2weather_tpu_torch.scripts.spectral_bands runs/h5_eval_trel03 runs/h5_eval_trel05 \
  > runs/h5_bands.md 2>&1
echo "[h5] band diagnostic rc=$?"

python "$REPO/scripts/h5_verdict.py" \
  --point-a runs/h5_eval_trel03 --point-b runs/h5_eval_trel05 \
  --bands runs/h5_bands.md --h3-eval runs/h3_eval_cosmo \
  --snapshot-kdata "${KDATA}"
echo "[h5] verdict composer rc=$?"

touch runs/h5_gate.DONE
echo "[h5] DONE $(date -u +%FT%TZ)"
