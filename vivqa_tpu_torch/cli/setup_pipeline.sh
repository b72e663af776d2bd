#!/usr/bin/env bash
##############################################################################
# ViVQA on PyTorch — complete setup + evaluation bootstrap.
#
# Counterpart of setup_vivqa_pipeline.sh (env -> data -> model ->
# evaluation) for vivqa_tpu_torch. Stages:
#   1. Environment check   python, torch, CUDA, nvcc, the card
#   2. Data                Kaggle ViVQA download, or --synthetic offline corpus
#   3. Model               HF snapshot download (optional, --model), or
#                          from-scratch config
#   4. Smoke run           one tiny end-to-end train run to validate the stack
#   5. Evaluation          full evaluate mode on the prepared data
#
# Usage:
#   bash vivqa_tpu_torch/cli/setup_pipeline.sh               # full flow (needs egress)
#   bash vivqa_tpu_torch/cli/setup_pipeline.sh --synthetic   # fully offline
#   bash vivqa_tpu_torch/cli/setup_pipeline.sh --skip-data --skip-eval
#   bash vivqa_tpu_torch/cli/setup_pipeline.sh --help
# Other arguments (--device cpu, --config model.yaml, ...) go to both
# pipeline runs; the runs use the card unless given --device cpu.
##############################################################################
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
CLI_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

GREEN='\033[0;32m'; BLUE='\033[0;34m'; RED='\033[0;31m'
YELLOW='\033[1;33m'; NC='\033[0m'

DATA_DIR="data"
OUT_DIR="outputs/setup"
KAGGLE_DATASET="ngocuong/vivqa-60k"
HF_MODEL=""
SYNTHETIC=0
SKIP_DATA=0
SKIP_SMOKE=0
SKIP_EVAL=0
EXTRA=()

print_stage()   { echo -e "\n${BLUE}==> $1${NC}"; }
print_success() { echo -e "${GREEN}[ok]${NC} $1"; }
print_warn()    { echo -e "${YELLOW}[warn]${NC} $1"; }
print_fail()    { echo -e "${RED}[fail]${NC} $1" >&2; }

usage() {
  sed -n '2,22p' "$0" | sed 's/^# \{0,1\}//'
  exit 0
}

while [ $# -gt 0 ]; do
  case "$1" in
    --help|-h) usage;;
    --synthetic) SYNTHETIC=1; shift;;
    --skip-data) SKIP_DATA=1; shift;;
    --skip-smoke) SKIP_SMOKE=1; shift;;
    --skip-eval) SKIP_EVAL=1; shift;;
    --data-dir) DATA_DIR="$2"; shift 2;;
    --out-dir) OUT_DIR="$2"; shift 2;;
    --dataset) KAGGLE_DATASET="$2"; shift 2;;
    --model) HF_MODEL="$2"; shift 2;;
    *) EXTRA+=("$1"); shift;;
  esac
done

##############################################################################
print_stage "Stage 1/5 — environment"
##############################################################################
python - << 'PY'
import sys
print(f"  python {sys.version.split()[0]}")
import numpy, torch  # noqa: F401
print(f"  torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}")
from vivqa_tpu_torch.ops import cuda_build
try:
    print(f"  nvcc: {cuda_build.find_nvcc()}")
except RuntimeError:
    print("  nvcc: not found (the kernels build only where it is)")
if torch.cuda.is_available():
    from vivqa_tpu_torch.device import card_line
    print(f"  card: {torch.cuda.device_count()} x {card_line()}")
else:
    print("  card: none (run the pipelines with --device cpu)")
import vivqa_tpu_torch  # noqa: F401
print("  vivqa_tpu_torch import OK")
PY
print_success "environment validated"

##############################################################################
print_stage "Stage 2/5 — data"
##############################################################################
if [ "$SKIP_DATA" = "1" ]; then
  print_warn "skipping data stage (--skip-data)"
  CSV=""; IMAGES=""
elif [ "$SYNTHETIC" = "1" ]; then
  python - "$DATA_DIR" << 'PY'
import sys
from vivqa_tpu_torch.data import generate_synthetic_vivqa
csv, imgs = generate_synthetic_vivqa(f"{sys.argv[1]}/synthetic", n=256,
                                     image_size=64, learnable=True)
print(f"  wrote {csv} + {imgs}")
PY
  CSV="$DATA_DIR/synthetic/data.csv"
  IMAGES="$DATA_DIR/synthetic/images"
  print_success "synthetic corpus ready (256 learnable samples)"
else
  bash "$CLI_DIR/download_data.sh" "$KAGGLE_DATASET" --out-dir "$DATA_DIR"
  CSV="$DATA_DIR/texts/evaluate_60k_data_balanced_preprocessed.csv"
  IMAGES="$DATA_DIR/images"
  [ -f "$CSV" ] || { print_fail "download incomplete: $CSV missing"; exit 1; }
  print_success "ViVQA data ready ($(ls "$IMAGES" | wc -l) images)"
fi

##############################################################################
print_stage "Stage 3/5 — model weights"
##############################################################################
if [ -n "$HF_MODEL" ]; then
  bash "$CLI_DIR/download_model.sh" "$HF_MODEL"
  print_success "HF snapshot of $HF_MODEL cached (graft it with --pretrained-visual / --pretrained-text)"
else
  print_warn "no --model given; pipelines will train from scratch"
fi

##############################################################################
print_stage "Stage 4/5 — smoke run (tiny end-to-end train)"
##############################################################################
if [ "$SKIP_SMOKE" = "1" ] || [ -z "$CSV" ]; then
  print_warn "skipping smoke run"
else
  python -m vivqa_tpu_torch.pipelines.vqa_pipeline --mode train \
    --csv-path "$CSV" --image-dir "$IMAGES" \
    --batch-size 8 --epochs 1 --image-size 64 \
    --output-dir "$OUT_DIR/smoke" ${EXTRA[@]+"${EXTRA[@]}"}
  [ -f "$OUT_DIR/smoke/pipeline_summary.json" ] || {
    print_fail "smoke run produced no summary"; exit 1; }
  print_success "smoke train run OK ($OUT_DIR/smoke/pipeline_summary.json)"
fi

##############################################################################
print_stage "Stage 5/5 — evaluation"
##############################################################################
if [ "$SKIP_EVAL" = "1" ] || [ -z "$CSV" ]; then
  print_warn "skipping evaluation"
else
  # resume from the smoke run's checkpoints when present
  RESUME_ARGS=()
  if [ "$SKIP_SMOKE" != "1" ] && [ -d "checkpoints/vqa" ]; then
    RESUME_ARGS=(--resume "checkpoints/vqa")
  fi
  python -m vivqa_tpu_torch.pipelines.vqa_pipeline --mode evaluate \
    --csv-path "$CSV" --image-dir "$IMAGES" \
    --batch-size 8 --image-size 64 \
    --output-dir "$OUT_DIR/eval" ${RESUME_ARGS[@]+"${RESUME_ARGS[@]}"} \
    ${EXTRA[@]+"${EXTRA[@]}"}
  print_success "evaluation complete ($OUT_DIR/eval)"
fi

echo -e "\n${GREEN}Setup pipeline finished.${NC} Outputs in $OUT_DIR/"
