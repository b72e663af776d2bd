"""The round-3 MoE ablation study through the PyTorch port on the card.

    python3 tools/ablation_study_r3.py OUT_DIR [--summary JSON]
        [--seed N] [--post-hoc]

The JAX package's ``reports/ablation_r3/run_study.sh`` in the port: the
9 experiments of ``reports/ablation_r3/study.yaml`` (full, no_moe, six
leave-one-outs over the specialized experts, the soft router swap) on
``generate_synthetic_vivqa(n=1024, image_size=64, seed=0,
learnable=True)``, with that script's flags (0.7 / 0.2 / 0.1 split, six
specialized experts and no others), through ``python -m
vivqa_tpu_torch.ablation.run_ablation``'s ``main``. The corpus, the
checkpoints, the result JSONs and the reports go under OUT_DIR; the run
resumes there as the CLI does. Each experiment's seconds and kernel
launches (counts set to 0 just before it and read just after,
``chip_smoke.recording_experiments``) and its metrics, telemetry and
paired statistics against the full baseline go to ``--summary``
(OUT_DIR/summary.json by default), with the card's name and power limit.
``--seed`` replaces the study's seed (42), which seeds every
experiment's initial weights and its dropout and router-noise draws;
``--post-hoc`` adds the post-hoc twin of each leave-one-out (the trained
full model evaluated with that expert masked, as
``reports/ablation_r5_control/`` does).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from vivqa_tpu_torch.ablation import (AblationConfig,  # noqa: E402
                                     AblationEvaluator)
from vivqa_tpu_torch.ablation import run_ablation  # noqa: E402
from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa  # noqa: E402
from vivqa_tpu_torch.device import card_line, resolve_device  # noqa: E402
from vivqa_tpu_torch.ops import flash_attention as fa  # noqa: E402

STUDY = Path(__file__).resolve().parent.parent / "reports/ablation_r3/study.yaml"


def main(out_dir: str, summary_path: str | None = None,
         seed: int | None = None, post_hoc: bool = False) -> dict:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = AblationConfig.from_yaml(STUDY)
    if seed is not None:
        cfg = cfg.replace(seed=seed)
    if post_hoc:
        cfg = cfg.replace(search=cfg.search.replace(post_hoc_masks=True))
    study = out / "study.yaml"
    cfg.to_yaml(study)
    resolve_device("cuda")
    chip_smoke.build_phase()
    corpus = out / "corpus"
    if not (corpus / "data.csv").exists():
        generate_synthetic_vivqa(corpus, n=1024, image_size=64, seed=0,
                                 learnable=True)
    argv = ["--config", str(study), "--csv-path", str(corpus / "data.csv"),
            "--image-dir", str(corpus / "images"), "--image-size", "64",
            "--train-ratio", "0.7", "--val-ratio", "0.2",
            "--specialized-experts", "6", "--vision-experts", "0",
            "--text-experts", "0", "--multimodal-experts", "0",
            "--output-dir", str(out / "runs"), "--device", "cuda"]
    records = []
    t0 = time.perf_counter()
    with chip_smoke.recording_experiments(records):
        results = run_ablation.main(argv)
    seconds = time.perf_counter() - t0
    ev = AblationEvaluator(results, "exact_match")
    summary = {
        "card": card_line(), "seconds": seconds,
        "seed": AblationConfig.from_yaml(study).seed,
        "experiments": {r.experiment_id: {
            "status": r.status, "exact_match": r.metrics.get("exact_match"),
            "n_eval": r.metrics.get("n_eval"),
            "wall_seconds": r.wall_seconds,
            "moe_metrics": r.moe_metrics,
            "mask_mean": (sum(r.correct_mask) / len(r.correct_mask)
                          if r.correct_mask else None),
            "history": [{k: h.get(k) for k in ("epoch", "train_loss",
                                               "val_loss", "exact_match")}
                        for h in r.history]} for r in results},
        "runs": [{k: rec.get(k) for k in ("id", "seconds", "launches",
                                          "train_steps", "val_batches")}
                 for rec in records],
        "paired": ev.paired_comparisons(),
        "noise_floor": ev.noise_floor(),
        "launch_names": list(fa.launch_counts)}
    path = Path(summary_path) if summary_path else out / "summary.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(summary, indent=1, default=str))
    print(json.dumps({k: summary[k] for k in ("card", "seconds")}))
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--summary", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--post-hoc", action="store_true")
    a = parser.parse_args()
    main(a.out_dir, a.summary, a.seed, a.post_hoc)
