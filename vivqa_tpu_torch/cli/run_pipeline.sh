#!/usr/bin/env bash
# Classification VQA pipeline wrapper (reference: src/cli/run_pipeline.sh).
# Usage: bash vivqa_tpu_torch/cli/run_pipeline.sh --mode train --config configs/pipeline_config.yaml [...]
# One process; on N cards of a host run the module under torchrun:
#   torchrun --standalone --nproc-per-node N -m vivqa_tpu_torch.pipelines.vqa_pipeline ...
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
GREEN='\033[0;32m'; CYAN='\033[0;36m'; NC='\033[0m'
echo -e "${CYAN}========================================${NC}"
echo -e "${GREEN}  ViVQA on PyTorch — classification pipeline${NC}"
echo -e "${CYAN}========================================${NC}"
exec python -m vivqa_tpu_torch.pipelines.vqa_pipeline "$@"
