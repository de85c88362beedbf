#!/usr/bin/env bash
# Canonical experiment configs on the port (counterpart of scripts/run_multi.sh,
# the reference's run_multi.sh lines 11-45): 512x1024 Cityscapes, 8 det
# classes, resnet-50_{det,seg,multi}, lr 5e-4, SGD m=0.9 wd=5e-4.
#
# Usage: dspnet_torch/scripts/run_multi.sh {train|eval|demo} [multi|det|seg] [extra args...]
#   env: MODEL_DIR (model), DATA_ROOT (data/cityscapes: a prepared directory or
#   {split}.drec), BATCH (1), END_EPOCH (2000), LOADER (native), PYTHON (python3).
#   The extra args come last, so they override the ones above (argparse keeps
#   the last); the entry points run on the card unless they say --device cpu.
set -euo pipefail

MODE=${1:-train}
TASK=${2:-multi}
shift $(( $# >= 2 ? 2 : $# )) || true

ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PY=${PYTHON:-python3}
NET="resnet-50_${TASK}"
SHAPE="3,512,1024"
MODEL_DIR=${MODEL_DIR:-model}
DATA_ROOT=${DATA_ROOT:-data/cityscapes}

case "$MODE" in
  train)
    "$PY" -m dspnet_torch.cli.multi_train \
      --network "$NET" --data-shape "$SHAPE" --num-classes 8 \
      --batch-size "${BATCH:-1}" --lr 0.0005 --momentum 0.9 --wd 0.0005 \
      --end-epoch "${END_EPOCH:-2000}" --seg-normalize valid \
      --dataset-root "$DATA_ROOT" --model-dir "$MODEL_DIR" \
      --loader "${LOADER:-native}" "$@"
    ;;
  eval)
    "$PY" -m dspnet_torch.cli.multi_eval \
      --network "$NET" --data-shape "$SHAPE" --num-classes 8 \
      --batch-size "${BATCH:-1}" --dataset-root "$DATA_ROOT" \
      --model-dir "$MODEL_DIR" "$@"
    ;;
  demo)
    "$PY" -m dspnet_torch.cli.multi_demo \
      --network "$NET" --data-shape "$SHAPE" \
      --model-dir "$MODEL_DIR" "$@"
    ;;
  *)
    echo "usage: $0 {train|eval|demo} [multi|det|seg] [extra args]" >&2
    exit 1
    ;;
esac
