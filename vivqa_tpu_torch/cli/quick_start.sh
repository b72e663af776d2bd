#!/usr/bin/env bash
# Quick start: get data (or synthesize an offline corpus), verify it,
# train with sensible defaults (reference: src/cli/quick_start.sh).
#
# Usage:
#   bash vivqa_tpu_torch/cli/quick_start.sh                 # Kaggle download + train
#   bash vivqa_tpu_torch/cli/quick_start.sh --synthetic     # offline synthetic corpus
#   bash vivqa_tpu_torch/cli/quick_start.sh --epochs 5 --batch-size 32
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
GREEN='\033[0;32m'; BLUE='\033[0;34m'; RED='\033[0;31m'; NC='\033[0m'

SYNTHETIC=0; EPOCHS=10; BATCH=16; DATA_DIR="data"; EXTRA=()
while [ $# -gt 0 ]; do
  case "$1" in
    --synthetic) SYNTHETIC=1; shift;;
    --epochs) EPOCHS="$2"; shift 2;;
    --batch-size) BATCH="$2"; shift 2;;
    --data-dir) DATA_DIR="$2"; shift 2;;
    *) EXTRA+=("$1"); shift;;
  esac
done

echo -e "${BLUE}=== ViVQA on PyTorch — quick start ===${NC}"

if [ "$SYNTHETIC" = "1" ]; then
  echo -e "${GREEN}[1/3]${NC} Generating synthetic learnable corpus in ${DATA_DIR}/synthetic ..."
  python - "$DATA_DIR" << 'PY'
import sys
from vivqa_tpu_torch.data import generate_synthetic_vivqa
csv, imgs = generate_synthetic_vivqa(f"{sys.argv[1]}/synthetic", n=256,
                                     image_size=64, learnable=True)
print(f"csv={csv}\nimages={imgs}")
PY
  CSV="$DATA_DIR/synthetic/data.csv"; IMAGES="$DATA_DIR/synthetic/images"
else
  echo -e "${GREEN}[1/3]${NC} Downloading ViVQA data from Kaggle ..."
  bash "$(dirname "$0")/download_data.sh" --out-dir "$DATA_DIR"
  CSV="$DATA_DIR/texts/evaluate_60k_data_balanced_preprocessed.csv"
  IMAGES="$DATA_DIR/images"
fi

echo -e "${GREEN}[2/3]${NC} Verifying data ..."
if [ ! -f "$CSV" ] || [ ! -d "$IMAGES" ]; then
  echo -e "${RED}Error:${NC} expected $CSV and $IMAGES to exist" >&2; exit 1
fi
echo "  $(ls "$IMAGES" | wc -l) images, csv: $CSV"

echo -e "${GREEN}[3/3]${NC} Training ..."
exec python -m vivqa_tpu_torch.pipelines.vqa_pipeline --mode train \
  --csv-path "$CSV" --image-dir "$IMAGES" \
  --batch-size "$BATCH" --epochs "$EPOCHS" "${EXTRA[@]}"
