"""Convergence check of the port's classification stack on the card: it
LEARNS, not just runs (counterpart of the root bench_convergence.py).

    python3 -m vivqa_tpu_torch.bench_convergence

Generates the learnable synthetic ViVQA corpus (the image content encodes
the answers; ``data/synthetic.py``), trains the demo-size classification
model end to end through the port's ``VQAPipeline`` on the card, and
prints ONE JSON line with the held-out exact-match trajectory, the root
script's keys plus the card's name and power limit. Pass criterion
(BASELINE.md): best held-out exact match >= 0.9 (answers are not
recoverable from the question alone).

Environment knobs as the root script's: CONV_SAMPLES (256), CONV_EPOCHS
(30), CONV_LR (3e-4), CONV_MIX_MODE (none | mixup | cutmix | both),
CONV_TEXT_AUG,
CONV_DROPOUT_SCHEDULE. Three more, to tell a seed's luck from the
card's arithmetic, which leave the recipe as it is while unset:
CONV_SEED (42, the pipelines' default: the model's init and the
training's dropout; the corpus, its split and its batch order keep seed
42), CONV_DTYPE (``bfloat16``; ``float32`` runs the encoders and their
attention kernels in f32, while MCAN and the head's hidden layer stay
bf16 in both packages) and CONV_DROPOUT (the text encoder's, fusion's
and head's rate, 0.1 each by their configs). A CUDA generator and a CPU
one draw other dropout masks from one seed, so only a run without
dropout is the same computation on the card and on the CPU.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.device import card_line, resolve_device
from vivqa_tpu_torch.models.config import (AnswerHeadConfig, FusionConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig)
from vivqa_tpu_torch.pipelines import (DataPipelineConfig,
                                       ModelPipelineConfig,
                                       TrainingPipelineConfig, VQAPipeline,
                                       VQAPipelineConfig)
from vivqa_tpu_torch.train.optimizers import OptimizerConfig, SchedulerConfig


def device_keys(device: torch.device) -> dict:
    """The card's name and nvidia-smi's name and power limit (the CPU's
    run says so and has no card line)."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    return {"device": torch.cuda.get_device_name(device),
            "card": card_line()}


def main(device: str = "cuda") -> dict:
    dev = resolve_device(device)
    n = int(os.environ.get("CONV_SAMPLES", 256))
    epochs = int(os.environ.get("CONV_EPOCHS", 30))
    lr = float(os.environ.get("CONV_LR", 3e-4))
    # full-augmentation spot-check knobs: CONV_MIX_MODE
    # (none|mixup|cutmix|both), CONV_TEXT_AUG (probability),
    # CONV_DROPOUT_SCHEDULE (""|linear|cosine)
    mix_mode = os.environ.get("CONV_MIX_MODE", "none")
    text_aug = float(os.environ.get("CONV_TEXT_AUG", 0.0))
    drop_sched = os.environ.get("CONV_DROPOUT_SCHEDULE", "")
    seed = int(os.environ.get("CONV_SEED", 42))
    dtype = os.environ.get("CONV_DTYPE", "bfloat16")
    rate = os.environ.get("CONV_DROPOUT")
    rates = {} if rate is None else {"dropout": float(rate)}
    with tempfile.TemporaryDirectory() as d:
        csv, imgs = generate_synthetic_vivqa(d, n=n, image_size=64,
                                             learnable=True)
        cfg = VQAPipelineConfig(
            mode="train",
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs), image_size=64,
                max_question_length=12, batch_size=32,
                augmentation_strength="light",
                text_augmentation=text_aug),
            model=ModelPipelineConfig(
                model=VQAModelConfig(
                    visual=VisualEncoderConfig(image_size=64, patch_size=8,
                                               hidden_dim=128, num_layers=4,
                                               num_heads=4, dtype=dtype),
                    text=TextEncoderConfig(vocab_size=512, hidden_dim=128,
                                           num_layers=4, num_heads=4,
                                           max_length=12, dtype=dtype,
                                           **rates),
                    fusion=FusionConfig(fusion_type="mcan", hidden_dim=128,
                                        num_heads=4, num_layers=2, **rates),
                    head=AnswerHeadConfig(**rates), dtype=dtype),
                device=str(dev), seed=seed),
            training=TrainingPipelineConfig(
                num_epochs=epochs, seed=seed,
                mix_mode=mix_mode,
                dropout_schedule=drop_sched,
                optimizer=OptimizerConfig(learning_rate=lr,
                                          weight_decay=0.0),
                scheduler=SchedulerConfig(name="warmup_cosine",
                                          warmup_ratio=0.05),
                metric_for_best="exact_match",
                early_stopping_patience=epochs,
                checkpoint_dir=os.path.join(d, "ck"), log_every=1000,
                num_display_samples=0),
            output_dir=os.path.join(d, "out"), seed=seed)
        summary = VQAPipeline(cfg).run()
    hist = summary["history"]
    em_curve = [round(h["exact_match"], 4) for h in hist]
    loss_curve = [round(h["train_loss"], 4) for h in hist]
    best_em = max(em_curve)
    out = {
        "metric": "convergence_val_exact_match",
        "value": best_em,
        "unit": "exact-match (best epoch, held-out split)",
        "passed": best_em >= 0.9,
        "val_em_curve": em_curve,
        "train_loss_curve": loss_curve,
        "vqa_accuracy_best": max(h["vqa_accuracy"] for h in hist),
    }
    if mix_mode != "none" or text_aug > 0 or drop_sched:
        out["augmentation"] = {"mix_mode": mix_mode,
                               "text_augmentation": text_aug,
                               "dropout_schedule": drop_sched}
    if seed != 42 or dtype != "bfloat16" or rates:
        out["variant"] = {"seed": seed, "dtype": dtype, **rates}
    out.update(device_keys(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
