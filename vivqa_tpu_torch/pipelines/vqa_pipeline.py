"""Classification VQA orchestrator, the main entry point (counterpart of
vivqa_tpu/pipelines/vqa_pipeline.py).

Counterpart of src/core/vqa_pipeline.py:30-553 in the reference:
``python -m vivqa_tpu_torch.pipelines.vqa_pipeline --mode
train|evaluate|inference --config cfg.yaml ...`` chains the Data, Model
and Training pipelines, logs a banner, and writes pipeline_summary.json
and run_stats.json to the output directory. CLI flags override YAML,
which overrides the dataclass defaults. It runs on the card unless
``--device cpu`` (``model.device``) is given; asking for the card on a
host without one raises. With ``--use-knowledge`` a ``KnowledgeProvider``
(from ``--kb-path``, else from the training split's QA pairs) wraps the
train, val and test loaders, and the model gains its
``KnowledgeAttention`` at the provider's dim. As in the JAX package, the
training run and ``evaluate`` pass the knowledge arrays to the model, and
``inference`` (``VQAPredictor``) does not.

Under ``torchrun --nproc-per-node N`` the YAML's ``model.mesh`` (a
``MeshConfig``; the default is data-parallel over every rank) places the
training and the evaluation on the ranks' mesh (``parallel/mesh.py``).
Global rank 0 alone logs, writes the summary, the statistics and the
predictions; ``inference`` runs the whole model on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import torch

from vivqa_tpu_torch.config.base import ConfigBase, merge_cli_overrides
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.eval.predictor import VQAPredictor
from vivqa_tpu_torch.knowledge.provider import (KnowledgeProvider,
                                                KnowledgeProviderConfig)
from vivqa_tpu_torch.parallel.mesh import process_rank
from vivqa_tpu_torch.pipelines.data_pipeline import (DataPipeline,
                                                     DataPipelineConfig)
from vivqa_tpu_torch.pipelines.model_pipeline import (ModelPipeline,
                                                      ModelPipelineConfig)
from vivqa_tpu_torch.pipelines.training_pipeline import (
    TrainingPipeline, TrainingPipelineConfig)
from vivqa_tpu_torch.utils import get_pipeline_logger
from vivqa_tpu_torch.utils.seeding import set_seed


@dataclasses.dataclass(frozen=True)
class VQAPipelineConfig(ConfigBase):
    mode: str = "train"                 # train | evaluate | inference
    data: DataPipelineConfig = dataclasses.field(
        default_factory=DataPipelineConfig)
    model: ModelPipelineConfig = dataclasses.field(
        default_factory=ModelPipelineConfig)
    training: TrainingPipelineConfig = dataclasses.field(
        default_factory=TrainingPipelineConfig)
    # host-side retrieval stage; active when model.model.knowledge
    # .use_knowledge is set (the reference retrieves inside forward,
    # vqa_model.py:689-702; here it is a stage wrapping the loaders)
    knowledge: KnowledgeProviderConfig = dataclasses.field(
        default_factory=KnowledgeProviderConfig)
    output_dir: str = "outputs/vqa"
    resume: str = ""                    # checkpoint dir to resume from
    seed: int = 42


def attach_knowledge(data_out, config: KnowledgeProviderConfig,
                     model_knowledge) -> KnowledgeProvider:
    """Both pipelines' knowledge stage: a provider with K from the model's
    knowledge config (the provider config's own ``num_retrieved`` gives
    way, as in the JAX pipelines), documents from ``kb_path``, else one
    fact per training QA pair (``KnowledgeProvider.from_samples``); it
    wraps ``data_out``'s train, val and test loaders."""
    kcfg = config.replace(num_retrieved=model_knowledge.num_retrieved)
    provider = KnowledgeProvider(kcfg) if kcfg.kb_path else \
        KnowledgeProvider.from_samples(kcfg, data_out.train_samples)
    data_out.train_loader = provider.wrap(data_out.train_loader)
    data_out.val_loader = provider.wrap(data_out.val_loader)
    data_out.test_loader = provider.wrap(data_out.test_loader)
    return provider


class VQAPipeline:
    def __init__(self, config: VQAPipelineConfig):
        self.config = config
        out = Path(config.output_dir)
        self.main = process_rank() == 0
        if self.main:
            out.mkdir(parents=True, exist_ok=True)
            self.log = get_pipeline_logger(reset=True, name="vqa_pipeline",
                                           log_dir=out / "logs")
        else:
            self.log = get_pipeline_logger(
                reset=True, name=f"vqa_pipeline_rank{process_rank()}",
                level=logging.ERROR)

    def run(self) -> dict:
        cfg = self.config
        if cfg.mode not in ("train", "evaluate", "inference"):
            raise ValueError(f"unknown mode '{cfg.mode}' "
                             "(choices: train, evaluate, inference)")
        log = self.log
        t0 = time.time()
        log.section("VIETNAMESE VQA PIPELINE (PyTorch)")
        log.key_value("mode", cfg.mode)
        dev = resolve_device(cfg.model.device)
        log.key_value("device", torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else str(dev))
        log.key_value("output_dir", cfg.output_dir)
        set_seed(cfg.seed)

        data_out = DataPipeline(cfg.data, log).run()

        # Knowledge/RAG stage: retrieve + encode K contexts per question
        # on the host and attach them to every batch.
        provider = None
        if cfg.model.model.knowledge.use_knowledge:
            provider = attach_knowledge(data_out, cfg.knowledge,
                                        cfg.model.model.knowledge)
            log.success(f"knowledge provider: {len(provider.documents)} "
                        f"docs, retriever={provider.config.retriever}, "
                        f"K={provider.config.num_retrieved}, "
                        f"dim={provider.dim}")

        # Sync the model config with what the data pipeline actually
        # produces: image size, question length, tokenizer vocab.
        mc = cfg.model.model
        if provider is not None:
            mc = mc.replace(knowledge=mc.knowledge.replace(
                knowledge_dim=provider.dim))
        mc = mc.replace(
            visual=mc.visual.replace(image_size=cfg.data.image_size),
            text=mc.text.replace(max_length=cfg.data.max_question_length,
                                 vocab_size=max(mc.text.vocab_size,
                                                data_out.tokenizer.vocab_size)
                                 if cfg.data.tokenizer_name
                                 else data_out.tokenizer.vocab_size))
        model_pipe = ModelPipeline(cfg.model.replace(model=mc), log)
        if cfg.resume:
            model_out, _ = model_pipe.load_checkpoint(
                cfg.resume, num_answers=len(data_out.answer2id))
        else:
            model_out = model_pipe.run(num_answers=len(data_out.answer2id))

        summary = {"mode": cfg.mode, "config": cfg.to_dict(),
                   "num_answers": len(data_out.answer2id),
                   "statistics": {k: v for k, v in
                                  data_out.statistics.items()
                                  if k != "top_answers"}}

        if cfg.mode == "train":
            train_out = TrainingPipeline(cfg.training, log).run(
                model_out.model, data_out.train_loader, data_out.val_loader,
                data_out.id2answer, model_out.mesh)
            summary["history"] = train_out.history
            summary["best_metric"] = train_out.best_metric
            summary["final_metrics"] = train_out.final_metrics
            summary["step_seconds"] = train_out.step_seconds
            summary["loop_seconds"] = train_out.loop_seconds
        elif cfg.mode == "evaluate":
            metrics = TrainingPipeline(cfg.training, log).validate(
                model_out.model, data_out.test_loader, data_out.id2answer,
                model_out.mesh)
            summary["metrics"] = metrics
            log.log_metrics(metrics, prefix="test/")
        else:
            predictor = VQAPredictor(model_out.model, data_out.tokenizer,
                                     data_out.id2answer,
                                     image_size=cfg.data.image_size,
                                     device=model_out.device)
            results = []
            for batch in data_out.test_loader:
                nv = batch.get("_num_valid", len(batch["question"]))
                for i, q in enumerate(batch["question"][:nv]):
                    r = predictor.predict_arrays(
                        batch["pixel_values"][i], q)
                    results.append(dataclasses.asdict(r))
            summary["num_predictions"] = len(results)
            if self.main:
                out_path = Path(cfg.output_dir) / "inference_results.json"
                out_path.write_text(json.dumps(results, ensure_ascii=False,
                                               indent=2))
                log.success(f"wrote {len(results)} predictions to "
                            f"{out_path}")

        summary["wall_seconds"] = time.time() - t0
        if self.main:
            self._save_summary(summary)
            log.save_stats(Path(cfg.output_dir) / "run_stats.json")
        return summary

    def _save_summary(self, summary: dict) -> None:
        path = Path(self.config.output_dir) / "pipeline_summary.json"
        path.write_text(json.dumps(summary, indent=2, default=str,
                                   ensure_ascii=False))
        self.log.success(f"summary saved to {path}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Vietnamese VQA pipeline "
                                            "(PyTorch, CUDA)")
    p.add_argument("--mode", choices=["train", "evaluate", "inference"],
                   default=None)
    p.add_argument("--config", type=str, default=None, help="YAML config")
    # --images-dir / --learning-rate / --text-encoder / --text-file are
    # the reference's flag names (vqa_pipeline.py:474) kept as aliases
    p.add_argument("--csv-path", "--text-file", dest="data.csv_path")
    p.add_argument("--image-dir", "--images-dir", dest="data.image_dir")
    p.add_argument("--batch-size", dest="data.batch_size", type=int)
    p.add_argument("--image-size", dest="data.image_size", type=int)
    p.add_argument("--max-question-length",
                   dest="data.max_question_length", type=int)
    p.add_argument("--epochs", dest="training.num_epochs", type=int)
    p.add_argument("--lr", "--learning-rate",
                   dest="training.optimizer.learning_rate", type=float)
    p.add_argument("--mix-mode", dest="training.mix_mode",
                   choices=["none", "mixup", "cutmix", "both"])
    p.add_argument("--mix-alpha", dest="training.mix_alpha", type=float)
    p.add_argument("--text-augmentation", dest="data.text_augmentation",
                   type=float, help="train-split text aug probability")
    p.add_argument("--dropout-schedule", dest="training.dropout_schedule",
                   choices=["", "linear", "cosine"])
    p.add_argument("--final-dropout", dest="training.final_dropout",
                   type=float)
    p.add_argument("--fusion", dest="model.model.fusion.fusion_type")
    p.add_argument("--pretrained-visual", dest="model.pretrained_visual",
                   help="HF name-or-path: init the visual tower from "
                        "converted pretrained weights")
    p.add_argument("--pretrained-text", dest="model.pretrained_text",
                   help="HF name-or-path: init the text tower from "
                        "converted pretrained weights")
    p.add_argument("--visual-backbone", dest="model.model.visual.backbone")
    p.add_argument("--text-backbone", "--text-encoder",
                   dest="model.model.text.backbone")
    p.add_argument("--use-moe", dest="model.model.moe.use_moe",
                   action="store_const", const=True, default=None)
    p.add_argument("--use-knowledge",
                   dest="model.model.knowledge.use_knowledge",
                   action="store_const", const=True, default=None)
    p.add_argument("--kb-path", dest="knowledge.kb_path")
    p.add_argument("--output-dir", dest="output_dir")
    p.add_argument("--resume", dest="resume")
    p.add_argument("--seed", dest="seed", type=int)
    p.add_argument("--device", dest="model.device",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    cfg = (VQAPipelineConfig.from_yaml(args.config) if args.config
           else VQAPipelineConfig())
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config",)}
    cfg = merge_cli_overrides(cfg, overrides)
    return VQAPipeline(cfg).run()


if __name__ == "__main__":
    main()
