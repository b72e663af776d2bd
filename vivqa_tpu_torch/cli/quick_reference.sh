#!/usr/bin/env bash
# Quick command reference of vivqa_tpu_torch (counterpart of
# QUICK_REFERENCE.sh). This prints the common workflows; it does not
# execute anything. Every command runs on the card unless given
# --device cpu.
cat <<'EOF'
=========================================================================
 ViVQA on PyTorch (H100) — quick reference
=========================================================================

# 1. Train classification VQA (CLIP-ViT + PhoBERT + MCAN)
bash vivqa_tpu_torch/cli/run_pipeline.sh --mode train \
    --config configs/pipeline_config.yaml \
    --csv-path data/vivqa/data.csv --image-dir data/vivqa/images

# 2. Evaluate a checkpoint
bash vivqa_tpu_torch/cli/run_pipeline.sh --mode evaluate \
    --config configs/pipeline_config.yaml --resume checkpoints/vqa

# 3. Batch inference (JSON export)
bash vivqa_tpu_torch/cli/run_pipeline.sh --mode inference \
    --config configs/pipeline_config.yaml --resume checkpoints/vqa

# 4. Train generative VQA (encoder-decoder, beam decode validation)
bash vivqa_tpu_torch/cli/run_generative.sh --mode train \
    --config configs/generative_configs.yaml

# 5. Interactive generative demo (REPL)
bash vivqa_tpu_torch/cli/run_generative.sh --mode demo \
    --config configs/generative_configs.yaml --resume checkpoints/generative

# 6. External ViVQA test-set evaluation from a checkpoint
bash vivqa_tpu_torch/cli/run_vivqa_eval.sh \
    --checkpoint-dir checkpoints/generative \
    --csv-path data/vivqa_test.csv --image-dir data/coco

# 7. MoE ablation study (expert/router sweeps, resumable)
bash vivqa_tpu_torch/cli/run_ablation.sh --config configs/ablation_configs.yaml \
    --csv-path data/vivqa/data.csv --image-dir data/vivqa/images --dry-run
bash vivqa_tpu_torch/cli/run_ablation.sh --config configs/ablation_configs.yaml \
    --csv-path data/vivqa/data.csv --image-dir data/vivqa/images \
    --experiments 0-5

# 8. One-command bootstrap (env -> data -> model -> smoke train -> eval)
bash vivqa_tpu_torch/cli/setup_pipeline.sh              # Kaggle download (needs egress)
bash vivqa_tpu_torch/cli/setup_pipeline.sh --synthetic  # fully offline
bash vivqa_tpu_torch/cli/quick_start.sh --synthetic --epochs 5

# 9. Data / model downloads and clean-output runs
bash vivqa_tpu_torch/cli/download_data.sh ngocuong/vivqa-60k --out-dir data
bash vivqa_tpu_torch/cli/download_model.sh vinai/phobert-base
bash vivqa_tpu_torch/cli/run_clean.sh --mode train ...   # warnings suppressed

# 10. Benchmarks and the step budget (on the card)
python -m vivqa_tpu_torch.bench                    # train QA-pairs/s
python -m vivqa_tpu_torch.bench_serving            # generative answers/s + p50/p95
python -m vivqa_tpu_torch.bench_convergence        # learnable-corpus accuracy check
python -m vivqa_tpu_torch.tools.profile_components # step by component, wall and busy
python -m vivqa_tpu_torch.tools.profile_towers --tower all

# 11. The host input pipeline: PIL against the native loader (built by
#     native/build.sh where libjpeg's headers are)
python -m vivqa_tpu_torch.tools.bench_input_pipeline

# 12. Tutorials (runnable, sectioned walkthroughs)
python -m vivqa_tpu_torch.examples.complete_vqa_pipeline  # end-to-end classification
python -m vivqa_tpu_torch.examples.vivqa_examples         # generative + external eval
python -m vivqa_tpu_torch.examples.moe_examples           # routers/experts/ablation masks
=========================================================================
EOF
