#!/usr/bin/env bash
# Kaggle ViVQA dataset download wrapper (reference: src/cli/download_data.sh).
# Usage: bash vivqa_tpu_torch/cli/download_data.sh [<kaggle-dataset-id>] [--out-dir data]
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
GREEN='\033[0;32m'; CYAN='\033[0;36m'; NC='\033[0m'
DATASET="ngocuong/vivqa-60k"
if [ $# -gt 0 ] && [ "${1#--}" = "$1" ]; then
  DATASET="$1"; shift
fi
echo -e "${CYAN}Downloading Kaggle dataset:${NC} ${GREEN}${DATASET}${NC}"
exec python -m vivqa_tpu_torch.data.downloaders kaggle "$DATASET" "$@"
