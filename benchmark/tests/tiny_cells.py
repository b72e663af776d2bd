"""Throwaway cells at tiny widths, added as files only: a copy of the
benchmark's data files in a temporary folder, with ``tiny-<cell>``
workloads over ``tiny-<config>`` configurations and ``tiny-<mix>``
traffic, for runs on the CPU."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CELLS = ("cls-train-b512", "gen-train-b512", "cls-infer-b512")
# the tiny cells' own limits: a bf16 program at width 64 on the CPU reads
# other gaps than the flagships on the card (sound runs: loss 1.7-2.1e-3,
# 3.2-7.4e-5; control 1.3-1.5e-2, 4.7e-4-1.1e-3)
LIMITS = {"cls-train-b512": {"loss_gap": 6e-3, "grad_gap": 0.03,
                             "change_gap": 0.035},
          "gen-train-b512": {"loss_gap": 3e-4, "grad_gap": 0.02,
                             "change_gap": 0.02},
          "cls-infer-b512": {"top1_gap": 0.04, "top5_logp_gap": 0.1,
                             "missing": 0}}


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["visual"].update(image_size=32, patch_size=16, hidden_dim=64,
                         num_layers=2, num_heads=4)
    cfg["text"].update(vocab_size=300, hidden_dim=64, num_layers=2,
                       num_heads=4, max_length=16)
    if "fusion" in cfg:
        cfg["fusion"].update(hidden_dim=64, num_heads=4, num_layers=1,
                             mcan_flat_mlp_dim=64)
        cfg["moe"].update(expert_hidden_dim=64)
        cfg["head"]["hidden_dims"] = [64]
        cfg["num_answers"] = 20
    else:
        cfg.update(fusion_dim=64, fusion_heads=4, fusion_layers=1,
                   vocab_size=300, decoder_layers=1, decoder_heads=4,
                   decoder_dim=64, decoder_ff_dim=128, max_answer_length=8,
                   max_question_length=16)
    return cfg


def tiny_bench(tmp: Path, batch: int = 8, block: int = 3) -> Path:
    """A benchmark folder under ``tmp`` holding the real data files and
    the tiny cells beside them (no BENCHMARK.json lists the tiny cells,
    so their runs report every metric they have)."""
    d = Path(tmp) / "benchmark"
    for sub in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, d / sub)
    for cell in CELLS:
        w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        c = json.loads((BENCH / "configs" / f"{w['config']}.json")
                       .read_text())
        c["config"] = tiny_config(c["config"])
        (d / "configs" / f"tiny-{w['config']}.json").write_text(
            json.dumps(c))
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t["batch"] = batch
        for f in t["fields"]:
            if f["kind"] == "question":
                f["length"] = [3, 14]
        (d / "traffic" / f"tiny-{w['traffic']}.json").write_text(
            json.dumps(t))
        w.update(config=f"tiny-{w['config']}",
                 traffic=f"tiny-{w['traffic']}", reference_block=block,
                 limits=LIMITS[cell])
        (d / "workloads" / f"tiny-{cell}.json").write_text(json.dumps(w))
    return d
