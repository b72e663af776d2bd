"""Generative VQA orchestrator (counterpart of
vivqa_tpu/pipelines/generative_vqa_pipeline.py).

Counterpart of src/core/generative_vqa_pipeline.py:64-1805 in the
reference: modes train / evaluate / inference / demo (interactive REPL),
tokenizer + data + model setup, an ASCII architecture summary, batch
inference with JSON export:

    python -m vivqa_tpu_torch.pipelines.generative_vqa_pipeline \\
        --mode train|evaluate|inference|demo --config cfg.yaml ...

CLI flags override YAML, which overrides the dataclass defaults.
``device`` is the card unless ``--device cpu`` is given; asking for the
card on a host without one raises. ``mesh`` (the YAML's, a
``MeshConfig``, as the JAX package's field; there is no flag, as in the
JAX CLI) joins the ranks a launcher started (``torchrun
--nproc-per-node N``; one process: the 1x1 mesh): train and evaluate run
on it (``GenerativeTrainingPipeline``), inference and the demo run the
whole model on every rank, and global rank 0 alone logs and writes. ``resume``
copies the best checkpoint of a port checkpoint directory
(``train/checkpoint.py``) into the model's parameters on its device.
With ``--use-knowledge`` a ``KnowledgeProvider`` (from ``--kb-path``,
else from the training split's QA pairs) wraps the train, val and test
loaders, and the model appends the K retrieved contexts to its memory;
train, evaluate and inference pass them to the model, the demo does not
(the JAX package's behaviour). ``--enable-resource-management`` starts
the module's ``ResourceManager`` (``resources/``) before the mode and
stops it after, as the JAX pipeline does. ``--pretrained-visual`` /
``--pretrained-text`` (a local HF model directory or a model in the local
HF cache, read without ``transformers`` by ``models/convert.py``)
re-derive the encoder sub-configs from the HF architecture and graft the
converted weights over the seeded model's ``visual_encoder`` and
``question_encoder``.

A ``model`` that is a ``DecoderVQAConfig`` (a YAML ``model:`` section
with ``kind: decoder_only``) builds the decoder-only ``DecoderVQAModel``
(``models/decoder_vqa.py``) instead, over the tokenizer's vocabulary;
it takes no pretrained text tower and no knowledge.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import torch

from vivqa_tpu_torch.config.base import (ConfigBase, dataclass_from_dict,
                                         merge_cli_overrides)
from vivqa_tpu_torch.data.augmentation import ImageAugmentation
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.knowledge.provider import KnowledgeProviderConfig
from vivqa_tpu_torch.models.config import (DecoderVQAConfig,
                                           GenerativeVQAConfig)
from vivqa_tpu_torch.models.convert import (graft_pretrained,
                                            load_pretrained_text_encoder,
                                            load_pretrained_visual_encoder)
from vivqa_tpu_torch.models.decoder_vqa import create_decoder_vqa_model
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.models.generative import create_generative_vqa_model
from vivqa_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                           logical_to_mesh, process_rank)
from vivqa_tpu_torch.pipelines.common import count_parameters
from vivqa_tpu_torch.pipelines.data_pipeline import (DataPipeline,
                                                     DataPipelineConfig)
from vivqa_tpu_torch.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig, GenerativeTrainingPipeline, batch_to_device)
from vivqa_tpu_torch.pipelines.vqa_pipeline import attach_knowledge
from vivqa_tpu_torch.resources import get_resource_manager
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              partial_load)
from vivqa_tpu_torch.train.state import knowledge_of
from vivqa_tpu_torch.utils import get_pipeline_logger
from vivqa_tpu_torch.utils.seeding import set_seed

MODES = ("train", "evaluate", "inference", "demo")


@dataclasses.dataclass(frozen=True)
class GenerativeVQAPipelineConfig(ConfigBase):
    mode: str = "train"            # train | evaluate | inference | demo
    data: DataPipelineConfig = dataclasses.field(
        default_factory=lambda: DataPipelineConfig(generative=True))
    model: GenerativeVQAConfig = dataclasses.field(
        default_factory=GenerativeVQAConfig)
    training: GenerativeTrainingConfig = dataclasses.field(
        default_factory=GenerativeTrainingConfig)
    device: str = "cuda"
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # host-side retrieval stage, active when model.knowledge.use_knowledge
    knowledge: KnowledgeProviderConfig = dataclasses.field(
        default_factory=KnowledgeProviderConfig)
    output_dir: str = "outputs/generative"
    resume: str = ""
    use_resource_manager: bool = False
    seed: int = 42
    # HF name-or-path of pretrained towers (converted through
    # models/convert.py); empty = random init
    pretrained_visual: str = ""
    pretrained_text: str = ""

    @classmethod
    def from_dict(cls, data: dict) -> "GenerativeVQAPipelineConfig":
        """As every config's, with a ``model`` section of ``kind``
        ``decoder_only`` read as a ``DecoderVQAConfig``."""
        model = data.get("model")
        if isinstance(model, dict) and \
                model.get("kind") == DecoderVQAConfig.kind:
            data = dict(data, model=DecoderVQAConfig.from_dict(model))
        return dataclass_from_dict(cls, data)


def _check_mode(cfg: GenerativeVQAPipelineConfig) -> None:
    """Raise for an unknown mode before any work is done."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode '{cfg.mode}' (choices: "
                         f"{', '.join(MODES)})")


class GenerativeVQAPipeline:
    def __init__(self, config: GenerativeVQAPipelineConfig):
        self.config = config
        out = Path(config.output_dir)
        self.main = process_rank() == 0
        if self.main:
            out.mkdir(parents=True, exist_ok=True)
            self.log = get_pipeline_logger(reset=True, name="generative_vqa",
                                           log_dir=out / "logs")
        else:
            self.log = get_pipeline_logger(
                reset=True, name=f"generative_vqa_rank{process_rank()}",
                level=logging.ERROR)
        self.mesh = None

    # ----- setup ------------------------------------------------------------
    def _setup(self):
        """(data output, model on the device with its weights)."""
        cfg = self.config
        data = cfg.data
        if not data.generative:
            data = data.replace(generative=True)
        self.mesh = create_mesh(cfg.mesh, cfg.device)
        device = resolve_device(self.mesh.device)
        self.log.success(f"device {device}, mesh {self.mesh.shape}"
                         + (f" over {self.mesh.backend}"
                            if self.mesh.backend else ""))
        data_out = DataPipeline(data, self.log).run()
        tok = data_out.tokenizer
        if isinstance(cfg.model, DecoderVQAConfig):
            model = self._decoder_only(cfg, data, tok, device)
            return data_out, self._resume(model)
        model_cfg = cfg.model.replace(
            vocab_size=tok.vocab_size,
            bos_token_id=tok.bos_token_id,
            eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id,
            max_answer_length=data.max_answer_length,
            visual=cfg.model.visual.replace(image_size=data.image_size),
            text=cfg.model.text.replace(
                max_length=data.max_question_length,
                vocab_size=tok.vocab_size))

        # pretrained towers: re-derive the encoder sub-configs from the
        # HF architecture, keep the converted weights for grafting after
        # the seeded init (reference generative_vqa_model.py:119-190)
        pre_visual = pre_text = None
        if cfg.pretrained_visual:
            enc, pre_visual = load_pretrained_visual_encoder(
                cfg.pretrained_visual, model_cfg.visual)
            if enc.config.image_size != data.image_size:
                raise ValueError(
                    f"pretrained visual encoder expects image_size="
                    f"{enc.config.image_size} but the data pipeline "
                    f"produces {data.image_size} — set data.image_size "
                    f"to match")
            model_cfg = model_cfg.replace(visual=enc.config)
            self.log.success(f"pretrained visual: {cfg.pretrained_visual}")
        if cfg.pretrained_text:
            enc, pre_text = load_pretrained_text_encoder(
                cfg.pretrained_text, model_cfg.text)
            enc_cfg = enc.config.replace(
                max_length=data.max_question_length)
            if enc_cfg.vocab_size != tok.vocab_size:
                self.log.warning(
                    f"pretrained text encoder vocab "
                    f"({enc_cfg.vocab_size}) != question tokenizer vocab "
                    f"({tok.vocab_size}) — use the matching HF tokenizer "
                    f"(data.tokenizer_name) or ids will not line up")
            model_cfg = model_cfg.replace(text=enc_cfg)
            self.log.success(f"pretrained text: {cfg.pretrained_text}")
        # knowledge/RAG stage: retrieved contexts become extra memory
        # tokens for the decoder
        if model_cfg.knowledge.use_knowledge:
            provider = attach_knowledge(data_out, cfg.knowledge,
                                        model_cfg.knowledge)
            model_cfg = model_cfg.replace(
                knowledge=model_cfg.knowledge.replace(
                    knowledge_dim=provider.dim))
            self.log.success(
                f"knowledge provider: {len(provider.documents)} docs, "
                f"retriever={provider.config.retriever}, "
                f"K={provider.config.num_retrieved}")
        model = create_generative_vqa_model(
            model_cfg, device=device,
            generator=torch.Generator().manual_seed(cfg.seed))
        if pre_visual is not None:
            graft_pretrained(model, "visual_encoder", pre_visual, self.log)
        if pre_text is not None:
            graft_pretrained(model, "question_encoder", pre_text, self.log)
        self._log_architecture(model_cfg, model)
        return data_out, self._resume(model)

    def _resume(self, model):
        """``model``, with the best checkpoint of ``resume`` loaded where
        one is given."""
        cfg = self.config
        if cfg.resume:
            # torch.load gives CPU tensors; partial_load copies them into
            # the parameters the model already has on its device, so the
            # model is never left holding host tensors
            mgr = CheckpointManager(CheckpointConfig(directory=cfg.resume))
            restored, _ = mgr.restore_best(map_location="cpu")
            partial_load(dict(restored.get("params", restored),
                              **restored.get("buffers", {})), model, self.log)
            self.log.success(f"resumed weights from {cfg.resume}")
        return model

    def _decoder_only(self, cfg, data, tok, device):
        """The decoder-only model over the tokenizer's vocabulary, with
        seeded weights."""
        if cfg.pretrained_visual or cfg.pretrained_text:
            raise NotImplementedError("the decoder-only model takes no "
                                      "pretrained towers")
        model_cfg = cfg.model.replace(
            vocab_size=tok.vocab_size, bos_token_id=tok.bos_token_id,
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
            max_answer_length=data.max_answer_length,
            max_question_length=data.max_question_length,
            visual=cfg.model.visual.replace(image_size=data.image_size))
        model = create_decoder_vqa_model(
            model_cfg, device=device,
            generator=torch.Generator().manual_seed(cfg.seed))
        self.log.subsection("DecoderVQAModel architecture")
        self.log.info("  pixel -> %s(%dl) -> projector -> [image; question;"
                      " answer] -> %d layers (%d dense, MoE %d of %d "
                      "experts held) -> vocab(%d)",
                      model_cfg.visual.backbone, model_cfg.visual.num_layers,
                      model_cfg.num_hidden_layers,
                      model_cfg.first_k_dense_replace,
                      model_cfg.experts_held[1] - model_cfg.experts_held[0],
                      model_cfg.n_routed_experts, model_cfg.vocab_size)
        self.log.log_model_architecture("DecoderVQAModel",
                                        count_parameters(model))
        return model

    def _log_architecture(self, model_cfg: GenerativeVQAConfig, model):
        log = self.log
        log.subsection("GenerativeVQAModel architecture")
        log.info("  pixel -> %s(%dl) \\", model_cfg.visual.backbone,
                 model_cfg.visual.num_layers)
        log.info("                     > fusion(%dl%s) -> decoder(%dl) -> vocab(%d)",
                 model_cfg.fusion_layers,
                 "+MoE" if model_cfg.moe.use_moe else "",
                 model_cfg.decoder_layers, model_cfg.vocab_size)
        log.info("  question -> %s(%dl) /", model_cfg.text.backbone,
                 model_cfg.text.num_layers)
        log.log_model_architecture("GenerativeVQAModel",
                                   count_parameters(model))

    # ----- run ---------------------------------------------------------------
    def run(self) -> dict:
        cfg = self.config
        _check_mode(cfg)
        log = self.log
        t0 = time.time()
        log.section("GENERATIVE VQA PIPELINE (PyTorch)")
        log.key_value("mode", cfg.mode)
        set_seed(cfg.seed)

        rm = None
        if cfg.use_resource_manager:
            rm = get_resource_manager()
            rm.start()

        try:
            data_out, model = self._setup()
            device = next(model.parameters()).device
            summary = {"mode": cfg.mode, "config": cfg.to_dict()}

            if cfg.mode == "train":
                tp = GenerativeTrainingPipeline(cfg.training, log)
                out = tp.run(model, data_out.train_loader,
                             data_out.val_loader, data_out.tokenizer,
                             self.mesh)
                summary["history"] = out.history
                summary["best_metric"] = out.best_metric
            elif cfg.mode == "evaluate":
                tp = GenerativeTrainingPipeline(cfg.training, log)
                mask = cfg.training.expert_mask
                if self.mesh.size > 1:
                    logical_to_mesh(model, self.mesh)
                metrics = tp._validate(
                    build_generate_fn(model, self._decode_cfg(model)),
                    data_out.test_loader, data_out.tokenizer, device,
                    torch.tensor(mask, dtype=torch.float32, device=device)
                    if mask else None, self.mesh)
                summary["metrics"] = metrics
                log.log_metrics(metrics, prefix="test/")
            elif cfg.mode == "inference":
                summary["results_path"] = str(
                    self._run_inference(data_out, model, device))
            else:
                self._demo(data_out, model, device)
        finally:
            if rm is not None:
                rm.stop()

        summary["wall_seconds"] = time.time() - t0
        if self.main:
            path = Path(cfg.output_dir) / "pipeline_summary.json"
            path.write_text(json.dumps(summary, indent=2, default=str,
                                       ensure_ascii=False))
            log.success(f"summary saved to {path}")
        return summary

    def _decode_cfg(self, model) -> DecodeConfig:
        t = self.config.training
        m = model.config
        return DecodeConfig(max_length=m.max_answer_length,
                            bos_token_id=m.bos_token_id,
                            eos_token_id=m.eos_token_id,
                            pad_token_id=m.pad_token_id,
                            strategy=t.decode_strategy,
                            num_beams=t.num_beams)

    def _run_inference(self, data_out, model, device) -> Path:
        generate = build_generate_fn(model, self._decode_cfg(model))
        tok = data_out.tokenizer
        results = []
        for batch in data_out.test_loader:
            dev = batch_to_device(batch, device)
            seqs, scores = generate(dev["pixel_values"], dev["question_ids"],
                                    dev["question_mask"], **knowledge_of(dev))
            seqs, scores = seqs.cpu().numpy(), scores.float().cpu().numpy()
            nv = batch.get("_num_valid", len(batch["question"]))
            for i, q in enumerate(batch["question"][:nv]):
                results.append({
                    "question": q,
                    "generated_answer": tok.decode(seqs[i]),
                    "score": float(scores[i]),
                    "references": batch["all_answers"][i],
                })
        path = Path(self.config.output_dir) / "inference_results.json"
        if self.main:
            path.write_text(json.dumps(results, ensure_ascii=False,
                                       indent=2))
            self.log.success(f"wrote {len(results)} generations to {path}")
        return path

    def _demo(self, data_out, model, device) -> None:
        """Interactive REPL (reference :1223-1285). Reads image path +
        question from stdin; 'quit' exits."""
        generate = build_generate_fn(model, self._decode_cfg(model))
        tok = data_out.tokenizer
        tf = ImageAugmentation(self.config.data.image_size, mode="eval")
        print("Generative VQA demo — 'quit' to exit")
        while True:
            try:
                img_path = input("image path> ").strip()
            except EOFError:
                break
            if img_path.lower() in ("quit", "exit", ""):
                break
            question = input("question> ").strip()
            px = torch.from_numpy(tf(img_path))[None].to(device)
            q = tok.encode_batch([question],
                                 self.config.data.max_question_length)
            seqs, scores = generate(
                px, torch.from_numpy(q["input_ids"]).long().to(device),
                torch.from_numpy(q["attention_mask"]).long().to(device))
            print(f"answer: {tok.decode(seqs[0].cpu().numpy())} "
                  f"(score {float(scores[0]):.2f})")


def build_argparser() -> argparse.ArgumentParser:
    """Grouped argparse matching the reference's flag surface
    (reference generative_vqa_pipeline.py:1557-1805), and ``--device``."""
    p = argparse.ArgumentParser(description="Generative VQA pipeline "
                                            "(PyTorch, CUDA)")
    p.add_argument("--mode", choices=list(MODES), default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--seed", dest="seed", type=int)
    p.add_argument("--output-dir", dest="output_dir")
    p.add_argument("--log-dir", dest="output_dir",
                   help="alias of --output-dir (logs live under it)")
    p.add_argument("--resume", dest="resume")
    p.add_argument("--checkpoint-dir", dest="training.checkpoint_dir")
    p.add_argument("--device", dest="device",
                   help="cuda (the default) or cpu")

    d = p.add_argument_group("data")
    d.add_argument("--csv-path", dest="data.csv_path")
    d.add_argument("--image-dir", "--images-dir", dest="data.image_dir")
    d.add_argument("--batch-size", dest="data.batch_size", type=int)
    d.add_argument("--train-ratio", dest="data.train_ratio", type=float)
    d.add_argument("--val-ratio", dest="data.val_ratio", type=float)
    d.add_argument("--max-question-length", dest="data.max_question_length",
                   type=int)
    d.add_argument("--max-answer-length", dest="data.max_answer_length",
                   type=int)
    d.add_argument("--vietnamese-optimized", dest="data.tokenizer_name",
                   action="store_const", const="vinai/phobert-base",
                   default=None,
                   help="use the PhoBERT word-segmented tokenizer")
    d.add_argument("--num-workers", type=int, default=None,
                   help="accepted for reference-CLI compatibility; the "
                        "loader prefetches in a host thread, not in "
                        "worker processes")

    m = p.add_argument_group("model")
    m.add_argument("--visual-backbone", dest="model.visual.backbone")
    m.add_argument("--text-encoder", dest="model.text.backbone")
    m.add_argument("--pretrained-visual", dest="pretrained_visual",
                   help="HF name-or-path: init the visual tower from "
                        "converted pretrained weights")
    m.add_argument("--pretrained-text", dest="pretrained_text",
                   help="HF name-or-path: init the question tower from "
                        "converted pretrained weights")
    m.add_argument("--hidden-size", dest="_hidden_size", type=int,
                   help="fusion AND decoder width (reference alias field)")
    m.add_argument("--num-decoder-layers", dest="model.decoder_layers",
                   type=int)
    m.add_argument("--num-attention-heads", dest="_num_heads", type=int,
                   help="fusion AND decoder heads")

    o = p.add_argument_group("moe")
    o.add_argument("--use-moe", dest="model.moe.use_moe",
                   action="store_const", const=True, default=None)
    o.add_argument("--moe-type", dest="model.moe.moe_type")
    o.add_argument("--moe-position", dest="model.moe.moe_position")
    o.add_argument("--num-experts", dest="model.moe.num_experts", type=int)
    o.add_argument("--num-vision-experts",
                   dest="model.moe.num_vision_experts", type=int)
    o.add_argument("--num-text-experts",
                   dest="model.moe.num_text_experts", type=int)
    o.add_argument("--num-multimodal-experts",
                   dest="model.moe.num_multimodal_experts", type=int)
    o.add_argument("--num-specialized-experts",
                   dest="model.moe.num_specialized_experts", type=int)
    o.add_argument("--expert-capacity-factor",
                   dest="model.moe.capacity_factor", type=float)
    o.add_argument("--moe-loss-weight", dest="training.moe_aux_weight",
                   type=float)

    k = p.add_argument_group("knowledge")
    k.add_argument("--use-knowledge", dest="model.knowledge.use_knowledge",
                   action="store_const", const=True, default=None)
    k.add_argument("--kb-path", "--knowledge-base-path",
                   dest="knowledge.kb_path")
    k.add_argument("--retriever-top-k", dest="knowledge.num_retrieved",
                   type=int)

    t = p.add_argument_group("training")
    t.add_argument("--epochs", dest="training.num_epochs", type=int)
    t.add_argument("--lr", "--learning-rate",
                   dest="training.optimizer.learning_rate", type=float)
    t.add_argument("--weight-decay", dest="training.optimizer.weight_decay",
                   type=float)
    t.add_argument("--warmup-ratio", dest="training.scheduler.warmup_ratio",
                   type=float)
    t.add_argument("--gradient-accumulation",
                   dest="training.optimizer.accumulate_steps", type=int)
    t.add_argument("--patience", dest="training.early_stopping_patience",
                   type=int)
    t.add_argument("--freeze-visual", dest="_freeze_visual",
                   action="store_true", default=False)
    t.add_argument("--freeze-text", dest="_freeze_text",
                   action="store_true", default=False)
    t.add_argument("--use-amp", action="store_true", default=False,
                   help="accepted for reference-CLI compatibility; compute "
                        "is bf16 by the model config (no GradScaler needed)")
    t.add_argument("--enable-resource-management",
                   dest="use_resource_manager", action="store_const",
                   const=True, default=None)
    t.add_argument("--disable-resource-management",
                   dest="use_resource_manager", action="store_const",
                   const=False)

    g = p.add_argument_group("generation")
    g.add_argument("--decode", dest="training.decode_strategy",
                   choices=["greedy", "top_k", "top_p", "beam"])
    g.add_argument("--do-sample", dest="training.decode_strategy",
                   action="store_const", const="top_p",
                   help="reference flag: sampling decode (nucleus)")
    g.add_argument("--num-beams", dest="training.num_beams", type=int)
    g.add_argument("--temperature", dest="training.temperature", type=float)
    g.add_argument("--top-k", dest="training.top_k", type=int)
    g.add_argument("--top-p", dest="training.top_p", type=float)
    g.add_argument("--max-generate-length",
                   dest="training.max_generate_length", type=int)
    return p


def _apply_flag_aliases(cfg, args) -> "GenerativeVQAPipelineConfig":
    """Reference alias fields that fan out to several config slots
    (reference GenerativeVQAConfig.__post_init__ syncing,
    generative_vqa_model.py:88)."""
    hs = getattr(args, "_hidden_size", None)
    if hs:
        cfg = cfg.replace(model=cfg.model.replace(
            fusion_dim=hs, decoder_dim=hs))
    nh = getattr(args, "_num_heads", None)
    if nh:
        cfg = cfg.replace(model=cfg.model.replace(
            fusion_heads=nh, decoder_heads=nh))
    if getattr(args, "_freeze_visual", False) and \
            getattr(args, "_freeze_text", False):
        raise SystemExit("--freeze-visual and --freeze-text are exclusive; "
                         "use training.strategy=linear_probe to train only "
                         "the fusion/decoder")
    if getattr(args, "_freeze_visual", False):
        cfg = cfg.replace(training=cfg.training.replace(
            strategy="freeze_visual"))
    if getattr(args, "_freeze_text", False):
        cfg = cfg.replace(training=cfg.training.replace(
            strategy="freeze_text"))
    # answer length must agree between the data pipeline and the decoder
    if cfg.data.max_answer_length != cfg.model.max_answer_length:
        cfg = cfg.replace(model=cfg.model.replace(
            max_answer_length=cfg.data.max_answer_length))
    return cfg


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    cfg = (GenerativeVQAPipelineConfig.from_yaml(args.config) if args.config
           else GenerativeVQAPipelineConfig())
    overrides = {k: v for k, v in vars(args).items()
                 if k != "config" and not k.startswith("_")}
    if args.mode is not None:
        overrides["mode"] = args.mode
    cfg = merge_cli_overrides(cfg, overrides)
    cfg = _apply_flag_aliases(cfg, args)
    return GenerativeVQAPipeline(cfg).run()


if __name__ == "__main__":
    main()
