#!/usr/bin/env bash
# HF model snapshot download wrapper (reference: src/cli/download_model.sh).
# Usage: bash vivqa_tpu_torch/cli/download_model.sh <hf-model-id> [--out-dir DIR]
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
if [ $# -lt 1 ]; then
  echo "usage: $0 <hf-model-id> [--out-dir DIR]" >&2; exit 1
fi
GREEN='\033[0;32m'; CYAN='\033[0;36m'; NC='\033[0m'
echo -e "${CYAN}Downloading HF model:${NC} ${GREEN}$1${NC}"
exec python -m vivqa_tpu_torch.data.downloaders hf-model "$@"
