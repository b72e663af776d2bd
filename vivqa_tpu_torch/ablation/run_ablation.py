"""Ablation study CLI (counterpart of vivqa_tpu/ablation/run_ablation.py,
with every one of its flags plus ``--device``).

--dry-run (list matrix and exit), --experiments "1,3,5-7" range parsing,
--rerun, --resume/--no-resume, --interactive selector, --report-only,
--backfill-masks, plus data/model bootstrap flags. The study trains on
the card (``--device cuda``, the default) or, at tiny sizes, on the CPU:

    python -m vivqa_tpu_torch.ablation.run_ablation \
        --csv-path data.csv --image-dir images/ --epochs 2 \
        --specialized-experts 6 --vision-experts 0 --text-experts 0 \
        --multimodal-experts 0 --experiments 0-3

Under ``torchrun --nproc-per-node N`` it runs its studies data-parallel
over the N ranks, as the JAX CLI does over every device
(``create_mesh(MeshConfig())``: every rank on 'data'); the batch size
must divide by N. Every rank trains and evaluates every experiment on
its rows; global rank 0 alone writes the results, checkpoints and
reports, and the others read what it wrote (``--report-only``, resume).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from vivqa_tpu_torch.ablation.config import AblationConfig
from vivqa_tpu_torch.utils import get_pipeline_logger


def parse_experiment_ranges(spec: str) -> List[int]:
    """'1,3,5-7' -> [1, 3, 5, 6, 7] (reference :167)."""
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-", 1)
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return sorted(set(out))


def dry_run(config: AblationConfig) -> None:
    matrix = config.generate_experiment_matrix()
    log = get_pipeline_logger()
    log.section(f"DRY RUN — {len(matrix)} experiments")
    log.table(("#", "experiment id", "priority"),
              [(i, e.experiment_id, e.priority)
               for i, e in enumerate(matrix)])


def interactive_select(config: AblationConfig) -> Optional[List[int]]:
    matrix = config.generate_experiment_matrix()
    dry_run(config)
    try:
        spec = input("experiments to run (e.g. 0,2-4; empty = all)> ").strip()
        if not spec:
            return None
        sel = parse_experiment_ranges(spec)
        confirm = input(f"run {len(sel)} experiments? [y/N]> ").strip()
        if confirm.lower() != "y":
            raise SystemExit("aborted")
        return sel
    except EOFError:
        return None


def report_only(config: AblationConfig, n_eval: Optional[int] = None,
                mesh=None):
    """Regenerate reports from persisted result JSONs (no training, no
    device). Mirrors the runner's final evaluate/analyze/report step so a
    finished (or interrupted) study can be re-analyzed offline — e.g.
    with a different --n-eval or after an analyzer change. On ``mesh``
    rank 0 writes the reports and every rank waits for them."""
    from vivqa_tpu_torch.parallel.mesh import barrier
    import json
    from pathlib import Path

    from vivqa_tpu_torch.ablation.analyzer import AblationAnalyzer
    from vivqa_tpu_torch.ablation.evaluator import AblationEvaluator
    from vivqa_tpu_torch.ablation.reporter import AblationReporter
    from vivqa_tpu_torch.ablation.trainer import ExperimentResult

    log = get_pipeline_logger()
    out = Path(config.output_dir)
    results = []
    for p in sorted((out / "results").glob("*.json")):
        try:
            results.append(ExperimentResult(**json.loads(p.read_text())))
        except (json.JSONDecodeError, TypeError) as e:
            log.warning("skipping unreadable result %s: %s", p.name, e)
    if not results:
        raise SystemExit(f"no result JSONs under {out / 'results'}")
    ev = AblationEvaluator(results, config.primary_metric,
                           config.model_type, n_eval=n_eval)
    an = AblationAnalyzer(ev)
    files = AblationReporter(ev, an, config.expert_label).save_all_reports(
        out / "reports")
    barrier(mesh)
    log.section(f"REPORT-ONLY: {len(ev.results)} completed results")
    for f in an.generate_key_findings():
        log.info("finding: %s", f)
    for k, v in files.items():
        log.key_value(k, v)
    return files


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MoE ablation study")
    p.add_argument("--config", type=str, help="ablation YAML")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    p.add_argument("--csv-path", type=str)
    p.add_argument("--image-dir", type=str, default="")
    p.add_argument("--model-type", choices=["classification", "generative"])
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--train-ratio", type=float, default=0.8)
    p.add_argument("--val-ratio", type=float, default=0.1)
    # model scale knobs (defaults = the round-3 study's scale)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--expert-hidden-dim", type=int, default=512)
    p.add_argument("--patch-size", type=int, default=16)
    # MoE expert composition (fixed order vision->text->multimodal->
    # specialized; ablation mask indices follow this order). Defaults
    # are None so an explicit flag is distinguishable from "unset" —
    # only explicit flags may override the YAML's search.num_experts
    p.add_argument("--vision-experts", type=int, default=None)
    p.add_argument("--text-experts", type=int, default=None)
    p.add_argument("--multimodal-experts", type=int, default=None)
    p.add_argument("--specialized-experts", type=int, default=None)
    p.add_argument("--output-dir", type=str)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--report-only", action="store_true",
                   help="regenerate reports from saved result JSONs in "
                        "<output-dir>/results without re-training")
    p.add_argument("--backfill-masks", action="store_true",
                   help="compute per-sample correct_mask for completed "
                        "experiments from their saved checkpoints (enables "
                        "paired McNemar tests on older studies)")
    p.add_argument("--n-eval", type=int, default=None,
                   help="val-set size for the noise-floor bound in "
                        "--report-only mode (new runs record it themselves)")
    p.add_argument("--experiments", type=str,
                   help="indices to run, e.g. '1,3,5-7'")
    p.add_argument("--rerun", action="store_true")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--resume", dest="resume", action="store_true",
                   default=True)
    p.add_argument("--no-resume", dest="resume", action="store_false")
    return p


def data_config(args, cfg: AblationConfig):
    """The corpus' DataPipelineConfig from the CLI's data flags."""
    from vivqa_tpu_torch.pipelines.data_pipeline import DataPipelineConfig
    return DataPipelineConfig(
        csv_path=args.csv_path or "", image_dir=args.image_dir,
        image_size=args.image_size, batch_size=cfg.batch_size,
        train_ratio=args.train_ratio, val_ratio=args.val_ratio,
        generative=(cfg.model_type == "generative"))


def base_model_config(args, cfg: AblationConfig, tok, data_cfg):
    """The study's model from the CLI's scale and expert-composition
    flags (as ``main`` resolves them) and the corpus' tokenizer: a ViT
    and a text encoder of ``--num-layers`` at ``--hidden-dim`` with 4
    heads, the VQA-MoE with the noisy top-k router, and the
    cross-attention fusion (2 layers, 4 heads) or, for the generative
    model, its fusion and a 2-layer decoder."""
    from vivqa_tpu_torch.models.config import (
        FusionConfig, GenerativeVQAConfig, MoEModelConfig, TextEncoderConfig,
        VisualEncoderConfig, VQAModelConfig)
    D, NL = args.hidden_dim, args.num_layers
    vis = VisualEncoderConfig(image_size=args.image_size,
                              patch_size=args.patch_size,
                              hidden_dim=D, num_layers=NL, num_heads=4)
    txt = TextEncoderConfig(vocab_size=tok.vocab_size, hidden_dim=D,
                            num_layers=NL, num_heads=4,
                            max_length=data_cfg.max_question_length)
    moe = MoEModelConfig(use_moe=True, moe_type="vqa",
                         router_type="noisy_topk",
                         num_vision_experts=args.vision_experts,
                         num_text_experts=args.text_experts,
                         num_multimodal_experts=args.multimodal_experts,
                         num_specialized_experts=args.specialized_experts,
                         expert_hidden_dim=args.expert_hidden_dim)
    if cfg.model_type == "generative":
        return GenerativeVQAConfig(
            visual=vis, text=txt, fusion_dim=D, fusion_layers=2,
            fusion_heads=4, vocab_size=tok.vocab_size,
            decoder_layers=2, decoder_heads=4, decoder_dim=D,
            decoder_ff_dim=4 * D, moe=moe,
            bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id,
            max_answer_length=data_cfg.max_answer_length)
    return VQAModelConfig(
        visual=vis, text=txt,
        fusion=FusionConfig(hidden_dim=D, num_heads=4, num_layers=2),
        moe=moe)


def world_size() -> int:
    """The ranks of the launch: the process group's, else the launcher's
    ``WORLD_SIZE``, else 1."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None):
    from vivqa_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    args = build_argparser().parse_args(argv)
    cfg = (AblationConfig.from_yaml(args.config) if args.config
           else AblationConfig())
    updates = {}
    for field, arg in (("model_type", args.model_type),
                       ("num_epochs", args.epochs),
                       ("batch_size", args.batch_size),
                       ("learning_rate", args.lr),
                       ("output_dir", args.output_dir)):
        if arg is not None:
            updates[field] = arg
    if updates:
        cfg = cfg.replace(**updates)
    # keep the search space's expert count in sync with the model's
    # actual composition (mismatched masks index out of range) — but
    # NEVER silently override a YAML num_experts with built-in defaults:
    # explicit flags win; otherwise the flags must agree with the YAML
    comp = [args.vision_experts, args.text_experts,
            args.multimodal_experts, args.specialized_experts]
    explicit = any(v is not None for v in comp)
    defaults = (2, 2, 2, 0)
    args.vision_experts, args.text_experts, args.multimodal_experts, \
        args.specialized_experts = (v if v is not None else d
                                    for v, d in zip(comp, defaults))
    total_experts = (args.vision_experts + args.text_experts
                     + args.multimodal_experts + args.specialized_experts)
    if cfg.search.num_experts != total_experts:
        if explicit:
            cfg = cfg.replace(search=cfg.search.replace(
                num_experts=total_experts))
        else:
            raise SystemExit(
                f"config declares search.num_experts="
                f"{cfg.search.num_experts} but the default expert "
                f"composition totals {total_experts}; pass --vision-"
                f"experts/--text-experts/--multimodal-experts/"
                f"--specialized-experts to match")
    if cfg.model_type == "generative" and cfg.primary_metric == "vqa_accuracy":
        cfg = cfg.replace(primary_metric="bleu")

    if args.dry_run:
        dry_run(cfg)
        return None

    if args.report_only:
        return report_only(cfg, n_eval=args.n_eval, mesh=create_mesh(
            MeshConfig(), args.device) if world_size() > 1 else None)

    selected = (parse_experiment_ranges(args.experiments)
                if args.experiments else None)
    if args.interactive:
        selected = interactive_select(cfg)

    # -- bootstrap data + base model config ---------------------------------
    from vivqa_tpu_torch.ablation.trainer import AblationTrainer
    from vivqa_tpu_torch.ablation.runner import AblationRunner
    from vivqa_tpu_torch.pipelines.data_pipeline import DataPipeline

    data_cfg = data_config(args, cfg)
    data_out = DataPipeline(data_cfg).run()
    base = base_model_config(args, cfg, data_out.tokenizer, data_cfg)
    mesh = create_mesh(MeshConfig(), args.device)
    trainer = AblationTrainer(cfg, base, data_out, args.device, mesh=mesh)
    runner = AblationRunner(cfg, trainer)
    if args.backfill_masks:
        # --rerun forces recomputation of masks that already exist
        return runner.backfill_masks(selected=selected, force=args.rerun)
    return runner.run(selected=selected, rerun=args.rerun,
                      resume=args.resume)


if __name__ == "__main__":
    main()
