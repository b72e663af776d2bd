#!/usr/bin/env bash
# Clean runner: all Python warnings suppressed for readable logs
# (reference: src/cli/run_clean.sh). Arguments pass through to the
# classification pipeline.
# One process; on N cards of a host run the module under torchrun:
#   torchrun --standalone --nproc-per-node N -m vivqa_tpu_torch.pipelines.vqa_pipeline ...
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:$PYTHONPATH}"
export PYTHONWARNINGS="ignore::FutureWarning,ignore::RuntimeWarning,ignore::DeprecationWarning,ignore::UserWarning"
exec python -m vivqa_tpu_torch.pipelines.vqa_pipeline "$@"
