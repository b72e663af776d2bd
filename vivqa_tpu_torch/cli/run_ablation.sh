#!/usr/bin/env bash
# MoE ablation study wrapper (reference: src/cli/ ablation scripts).
# One process; on N cards of a host run the module under torchrun:
#   torchrun --standalone --nproc-per-node N -m vivqa_tpu_torch.ablation.run_ablation ...
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
GREEN='\033[0;32m'; CYAN='\033[0;36m'; NC='\033[0m'
echo -e "${CYAN}========================================${NC}"
echo -e "${GREEN}  ViVQA on PyTorch — MoE ablation study${NC}"
echo -e "${CYAN}========================================${NC}"
exec python -m vivqa_tpu_torch.ablation.run_ablation "$@"
