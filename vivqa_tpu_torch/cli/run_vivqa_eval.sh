#!/usr/bin/env bash
# External ViVQA checkpoint evaluation (reference: vivqa_eval_cli).
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
exec python -m vivqa_tpu_torch.pipelines.vivqa_evaluation "$@"
