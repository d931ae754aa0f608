#!/bin/bash
# Full ATPE corpus sweep with the PyTorch/CUDA package: one shard per
# training domain (so partial progress survives interruption), then fit +
# held-out validation + artifact write into OUT_DIR.  Every TPE suggest
# runs on the CUDA card (--device cuda).
#   bash scripts/atpe_corpus_sweep_torch.sh [ROWS_DIR] [SEEDS] [SEED_OFFSET] [OUT_DIR]
# SEED_OFFSET gives a disjoint seed range (corpus rows are deterministic
# per seed, so a replication run MUST use a non-overlapping offset or it
# regenerates the original rows).
#
# The fit runs only when OUT_DIR is given (and SKIP_FIT is not 1): the
# trainer's own default --out is the shipped artifact directory, which
# this script never writes.  Fitting needs scikit-learn and fails naming
# it where sklearn does not import.  On a card machine without it, build
# the shards there (SKIP_FIT=1, or no OUT_DIR), then fit them where
# sklearn is installed; the shards are plain pickles that either
# package's --fit-from reads:
#   python -m hyperopt_tpu_torch.models.train_atpe --fit-from ROWS/*.pkl \
#       --device cpu --out DIR
# (--device cpu runs the held-out check's ATPE suggests on the CPU).
set -u
cd "$(dirname "$0")/.." || exit 1
ROWS=${1:-${TMPDIR:-/tmp}/atpe_rows}
SEEDS=${2:-13}
SEED_OFFSET=${3:-0}
OUT=${4:-}
mkdir -p "$ROWS"

DOMAINS="quadratic1 q1_lognormal n1 gauss_wave gauss_wave2 distractor hartmann6 many_dists nested_arch rosen10"

for d in $DOMAINS; do
  # seed range in the shard name: a rerun with different SEEDS/OFFSET
  # must not silently reuse (or mix with) another range's shards
  SHARD="$ROWS/$d.s${SEED_OFFSET}_${SEEDS}.pkl"
  if [ -s "$SHARD" ]; then
    echo "$(date -u +%FT%TZ) shard $SHARD already present, skipping"
    continue
  fi
  echo "$(date -u +%FT%TZ) building shard $SHARD"
  python -m hyperopt_tpu_torch.models.train_atpe --device cuda \
    --domains "$d" --seeds "$SEEDS" --seed-offset "$SEED_OFFSET" \
    --configs 20 --cont-evals 8 \
    --checkpoints 20 28 36 45 --rows-out "$SHARD" \
    || echo "$(date -u +%FT%TZ) shard $d FAILED"
done

if [ "${SKIP_FIT:-0}" = "1" ] || [ -z "$OUT" ]; then
  echo "$(date -u +%FT%TZ) shards done; fit them where sklearn imports with"
  echo "  python -m hyperopt_tpu_torch.models.train_atpe --fit-from $ROWS/*.pkl --device cpu --out DIR"
  exit 0
fi
echo "$(date -u +%FT%TZ) fitting from shards into $OUT"
python -m hyperopt_tpu_torch.models.train_atpe --device cuda --fit-from "$ROWS"/*.pkl --out "$OUT"
echo "$(date -u +%FT%TZ) sweep done"
