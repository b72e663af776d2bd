"""Generative convergence check of the port on the card: the SEQ2SEQ stack
LEARNS (counterpart of the root bench_convergence_gen.py).

    python3 -m vivqa_tpu_torch.bench_convergence_gen

Generates the learnable synthetic corpus with compositional multi-token
answers (``seq_answers=True``: the decoder must compose count, object
and colour from the IMAGE; answers are unrecoverable from the question),
trains GenerativeVQAModel end to end through the port's
GenerativeVQAPipeline on the card (teacher forcing, BLEU-best
checkpointing), validates every epoch with the KV-cached greedy decode,
then re-evaluates the BLEU-best checkpoint with beam search through
``mode="evaluate"`` and ``resume``. Prints ONE JSON line: the root
script's keys plus the card's name and power limit. Pass criterion
(BASELINE.md): best val exact match >= 0.85 with the greedy decode.

Environment knobs as the root script's: GEN_SAMPLES (512), GEN_EPOCHS
(60), GEN_LR (1e-3), GEN_BEAMS (4; 0 skips the beam evaluation),
GEN_DROPOUT (0.05), GEN_AUG (medium), GEN_WD (0.01), GEN_MODEL
(``flagship``: bench_serving's model at 224 px, to fit a checkpoint
that emits real EOS for the fitted serving bench), GEN_CORPUS_DIR (a
rendered corpus reused across runs; its manifest must match), GEN_CKPT
(keep the checkpoints there) and GEN_RESUME (start from GEN_CKPT's best
parameters).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from vivqa_tpu_torch.bench_convergence import device_keys
from vivqa_tpu_torch.data import ensure_synthetic_vivqa
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.models.config import (GenerativeVQAConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.pipelines import (DataPipelineConfig,
                                       GenerativeTrainingConfig,
                                       GenerativeVQAPipeline,
                                       GenerativeVQAPipelineConfig)
from vivqa_tpu_torch.train.optimizers import OptimizerConfig, SchedulerConfig


def model_config(flagship: bool, dropout: float) -> GenerativeVQAConfig:
    """The root script's two models: bench_serving's at 224 px, or the
    demo-size one."""
    if flagship:
        return GenerativeVQAConfig(
            visual=VisualEncoderConfig(backbone="clip", image_size=224,
                                       patch_size=32, hidden_dim=768,
                                       num_layers=12, num_heads=12),
            text=TextEncoderConfig(backbone="phobert", vocab_size=64001,
                                   hidden_dim=768, num_layers=12,
                                   num_heads=12, max_length=64),
            fusion_dim=512, fusion_layers=3, fusion_heads=8,
            vocab_size=64001, decoder_layers=6, decoder_heads=8,
            decoder_dim=512, decoder_ff_dim=2048,
            max_answer_length=32, dropout=dropout, label_smoothing=0.0)
    return GenerativeVQAConfig(
        visual=VisualEncoderConfig(image_size=64, patch_size=8,
                                   hidden_dim=128, num_layers=4,
                                   num_heads=4),
        text=TextEncoderConfig(vocab_size=512, hidden_dim=128,
                               num_layers=2, num_heads=4, max_length=12),
        fusion_dim=128, fusion_layers=2, fusion_heads=4,
        decoder_layers=2, decoder_heads=4, decoder_dim=128,
        decoder_ff_dim=512, dropout=dropout, label_smoothing=0.0)


def main(device: str = "cuda") -> dict:
    dev = resolve_device(device)
    n = int(os.environ.get("GEN_SAMPLES", 512))
    epochs = int(os.environ.get("GEN_EPOCHS", 60))
    lr = float(os.environ.get("GEN_LR", 1e-3))
    beams = int(os.environ.get("GEN_BEAMS", 4))
    dropout = float(os.environ.get("GEN_DROPOUT", 0.05))
    flagship = os.environ.get("GEN_MODEL", "") == "flagship"
    # "medium" (rotation/translate/erasing) spatially scrambles the
    # per-image noise so the decoder cannot memorize it as a sample key
    aug = os.environ.get("GEN_AUG", "medium")
    wd = float(os.environ.get("GEN_WD", 0.01))
    img_size = 224 if flagship else 64
    model_cfg = model_config(flagship, dropout)
    with tempfile.TemporaryDirectory() as d:
        corpus_dir = os.environ.get("GEN_CORPUS_DIR") or d
        csv, imgs = ensure_synthetic_vivqa(corpus_dir, n=n,
                                           image_size=img_size,
                                           learnable=True,
                                           seq_answers=True)
        print(f"[bench_convergence_gen] corpus ready ({n} samples)",
              file=sys.stderr, flush=True)
        ckpt_dir = os.environ.get("GEN_CKPT") or os.path.join(d, "ck")
        cfg = GenerativeVQAPipelineConfig(
            mode="train",
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=img_size,
                max_question_length=model_cfg.text.max_length
                if flagship else 12,
                max_answer_length=model_cfg.max_answer_length
                if flagship else 10,
                batch_size=32, augmentation_strength=aug,
                generative=True),
            model=model_cfg,
            training=GenerativeTrainingConfig(
                num_epochs=epochs,
                optimizer=OptimizerConfig(learning_rate=lr,
                                          weight_decay=wd),
                scheduler=SchedulerConfig(name="warmup_cosine",
                                          warmup_ratio=0.05),
                label_smoothing=0.0,
                metric_for_best="bleu",
                early_stopping_patience=epochs,
                decode_strategy="greedy",
                checkpoint_dir=ckpt_dir, log_every=1000),
            device=str(dev),
            resume=ckpt_dir if os.environ.get("GEN_RESUME") else "",
            output_dir=os.path.join(d, "out"))
        summary = GenerativeVQAPipeline(cfg).run()
        hist = summary["history"]
        em_curve = [round(h["exact_match"], 4) for h in hist]
        bleu_curve = [round(h["bleu"], 4) for h in hist]
        loss_curve = [round(h["train_loss"], 4) for h in hist]
        best_em = max(em_curve)

        beam_em = None
        if beams:
            # the beam path on the fitted model: the BLEU-best checkpoint
            # re-evaluated on the test split with beam search
            cfg_b = cfg.replace(
                mode="evaluate", resume=ckpt_dir,
                training=cfg.training.replace(decode_strategy="beam",
                                              num_beams=beams))
            res = GenerativeVQAPipeline(cfg_b).run()
            beam_em = round(res["metrics"]["exact_match"], 4)

    out = {
        "metric": "gen_convergence_val_exact_match",
        "value": best_em,
        "unit": "exact-match (best epoch, held-out split, greedy decode)",
        "passed": best_em >= 0.85,
        "val_em_curve": em_curve,
        "val_bleu_curve": bleu_curve,
        "train_loss_curve": loss_curve,
        "bleu_best": max(bleu_curve),
    }
    if beam_em is not None:
        out[f"beam{beams}_exact_match"] = beam_em
    out.update(device_keys(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
