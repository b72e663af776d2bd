"""Checkpoint-only evaluation on an external ViVQA CSV (counterpart of
vivqa_tpu/pipelines/vivqa_evaluation.py).

Counterpart of src/core/vivqa_evaluation_pipeline.py:53-525 and
vivqa_eval_cli.py in the reference: loads a generative checkpoint,
rebuilds the model config from checkpoint metadata, runs the inference
loop over an `img_id`-keyed CSV, decodes, computes EM / token-level
P-R-F1 / BLEU / ROUGE / METEOR / CIDEr, and exports predictions +
metrics JSON:

    python -m vivqa_tpu_torch.pipelines.vivqa_evaluation \\
        --checkpoint-dir ckpt --csv-path data.csv --image-dir images

It reads the port's checkpoints (``train/checkpoint.py``: ``torch.save``
per step and a ``metadata.json`` holding the model config), not the JAX
package's orbax ones. It runs on the card unless ``--device cpu`` is
given. A trailing partial batch is padded to the batch size by the
loader; its padding rows are decoded but neither scored nor written (the
JAX package scores and writes them: ROADMAP.md Queue C).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.data import (BatchLoader, GenerativeVQADataset,
                                  ImageAugmentation, OneSample,
                                  build_image_index, create_tokenizer,
                                  generative_collate, parse_answers)
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.metrics import (BLEUScore, CIDErScore,
                                     ExactMatchAccuracy, METEORScore,
                                     PrecisionRecallF1, ROUGEScore)
from vivqa_tpu_torch.models.config import GenerativeVQAConfig
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.models.generative import create_generative_vqa_model
from vivqa_tpu_torch.pipelines.generative_training_pipeline import \
    batch_to_device
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              partial_load)
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass(frozen=True)
class VivqaEvaluationConfig(ConfigBase):
    checkpoint_dir: str = ""
    csv_path: str = ""
    image_dir: str = ""
    image_size: int = 224
    batch_size: int = 16
    max_question_length: int = 64
    max_answer_length: int = 64
    decode_strategy: str = "greedy"
    num_beams: int = 4
    output_dir: str = "outputs/vivqa_eval"
    max_samples: int = 0
    device: str = "cuda"


def load_vivqa_csv(csv_path, image_dir, max_samples=0):
    """ViVQA CSV uses `img_id` (+ COCO zero-padded file resolution,
    reference vivqa_dataset.py:126-177) with `question`,`answer` columns."""
    import pandas as pd
    df = pd.read_csv(csv_path)
    qcol = "question"
    acol = "answer" if "answer" in df.columns else "answers"
    icol = "img_id" if "img_id" in df.columns else "image_link"
    index = build_image_index(image_dir) if image_dir else {}
    samples = []
    for _, row in df.iterrows():
        img = str(row[icol])
        path = None
        for cand in (img, f"{img}.jpg", f"{int(row[icol]):012d}.jpg"
                     if str(row[icol]).isdigit() else img):
            if cand in index:
                path = index[cand]
                break
        samples.append(OneSample(image_path=path or img,
                                 question=str(row[qcol]),
                                 answers=parse_answers(row[acol])))
        if max_samples and len(samples) >= max_samples:
            break
    return samples


def load_model_from_checkpoint(ckpt_dir: str, logger=None,
                               device: str | torch.device = "cuda"):
    """Rebuild GenerativeVQAConfig from the best checkpoint's metadata,
    build the model on ``device`` and copy the checkpoint's parameters
    into it there, once (reference vivqa_eval_cli.py:30). Returns (model,
    metadata)."""
    mgr = CheckpointManager(CheckpointConfig(directory=ckpt_dir))
    restored, meta = mgr.restore_best(map_location="cpu")
    cfg_dict = meta.get("config")
    if not cfg_dict:
        raise ValueError(f"checkpoint at {ckpt_dir} has no model config "
                         "metadata")
    cfg = GenerativeVQAConfig.from_dict(cfg_dict)
    model = create_generative_vqa_model(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    partial_load(restored.get("params", restored), model, logger)
    return model, meta


class VivqaEvaluationPipeline:
    def __init__(self, config: VivqaEvaluationConfig):
        self.config = config
        self.log = get_pipeline_logger(reset=True, name="vivqa_eval")

    def evaluate(self, model=None, tokenizer=None) -> dict:
        cfg = self.config
        log = self.log
        log.section("ViVQA EXTERNAL EVALUATION")

        if model is None:
            model, _ = load_model_from_checkpoint(
                cfg.checkpoint_dir, log, resolve_device(cfg.device))
        device = next(model.parameters()).device
        samples = load_vivqa_csv(cfg.csv_path, cfg.image_dir,
                                 cfg.max_samples)
        log.key_value("samples", len(samples))
        if tokenizer is None:
            corpus = [s.question for s in samples] + \
                     [a for s in samples for a in s.answers]
            tokenizer = create_tokenizer(None, cfg.max_question_length,
                                         corpus)

        ds = GenerativeVQADataset(
            samples, tokenizer,
            ImageAugmentation(cfg.image_size, mode="eval"),
            cfg.max_question_length, cfg.max_answer_length)
        loader = BatchLoader(ds, cfg.batch_size, generative_collate,
                             shuffle=False, drop_last=False)

        m = model.config
        generate = build_generate_fn(model, DecodeConfig(
            max_length=m.max_answer_length, bos_token_id=m.bos_token_id,
            eos_token_id=m.eos_token_id, pad_token_id=m.pad_token_id,
            strategy=cfg.decode_strategy, num_beams=cfg.num_beams))

        bleu, meteor, rouge = BLEUScore(), METEORScore(), ROUGEScore()
        cider, em, prf = CIDErScore(), ExactMatchAccuracy(), PrecisionRecallF1()
        predictions = []
        for batch in loader:
            dev = batch_to_device(batch, device)
            seqs, _ = generate(dev["pixel_values"], dev["question_ids"],
                               dev["question_mask"])
            nv = batch["_num_valid"]
            preds = [tokenizer.decode(s) for s in seqs[:nv].cpu().numpy()]
            refs = batch["all_answers"][:nv]
            for metric in (bleu, meteor, rouge, cider, em, prf):
                metric.update(preds, refs)
            for q, p, r in zip(batch["question"][:nv], preds, refs):
                predictions.append({"question": q, "prediction": p,
                                    "references": r})

        prf_r = prf.compute()
        rouge_r = rouge.compute()
        metrics = {
            "exact_match": em.compute().value,
            "precision": prf_r.metadata["precision"],
            "recall": prf_r.metadata["recall"],
            "f1": prf_r.value,
            "bleu": bleu.compute().value,
            "meteor": meteor.compute().value,
            "rouge_l": rouge_r.value,
            "rouge1": rouge_r.metadata["rouge1"],
            "cider": cider.compute().value,
        }
        log.log_metrics(metrics, prefix="vivqa/")

        out = Path(cfg.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "predictions.json").write_text(
            json.dumps(predictions, ensure_ascii=False, indent=2))
        (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
        log.success(f"results saved to {out}")
        return {"metrics": metrics, "num_samples": len(samples)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="ViVQA checkpoint evaluation "
                                            "(PyTorch, CUDA)")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--csv-path", required=True)
    p.add_argument("--image-dir", default="")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--decode", default="greedy")
    p.add_argument("--num-beams", type=int, default=4)
    p.add_argument("--output-dir", default="outputs/vivqa_eval")
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    cfg = VivqaEvaluationConfig(
        checkpoint_dir=args.checkpoint_dir, csv_path=args.csv_path,
        image_dir=args.image_dir, batch_size=args.batch_size,
        decode_strategy=args.decode, num_beams=args.num_beams,
        output_dir=args.output_dir, max_samples=args.max_samples,
        device=args.device)
    return VivqaEvaluationPipeline(cfg).evaluate()


if __name__ == "__main__":
    main()
