"""The ablation CLI on two 'data' ranks against one process, on the CPU.

``run_ablation.main`` under a launcher builds ``create_mesh(MeshConfig())``
(every rank on 'data', as the JAX CLI puts every device) and trains and
evaluates each experiment on it; only global rank 0 writes. Two gloo
ranks (tests/test_torch_parallel_ranks.py: ``ablation_job``) run a tiny
study of two rows, the full model with the soft router (no routing noise
to draw) and a post-hoc masked twin, at dropout 0; this process runs the
same study alone. Then each side runs it again (it resumes) and with
``--report-only``.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from vivqa_tpu_torch.ablation import AblationConfig, AblationSearchSpace
from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
from vivqa_tpu_torch.parallel.launch import start_ranks

torch.set_num_threads(1)
ROWS = ("full__soft_k0_lb0.01", "ph_single_expert_0__soft_k0_lb0.01")


def model_metrics(result: dict) -> dict:
    """A result's metrics but the throughput (a clock's, not the
    model's)."""
    return {k: v for k, v in result["metrics"].items()
            if not k.endswith("per_sec")}


def _argv(root: Path, csv, imgs, name: str) -> list:
    study = root / f"{name}.yaml"
    AblationConfig(
        search=AblationSearchSpace(num_experts=3, include_leave_one_out=False,
                                   include_single_expert=True,
                                   router_types=("soft",),
                                   post_hoc_masks=True),
        num_epochs=2, batch_size=8, learning_rate=5e-3,
        primary_metric="exact_match",
        output_dir=str(root / name)).to_yaml(study)
    return ["--config", str(study), "--csv-path", str(csv), "--image-dir",
            str(imgs), "--image-size", "16", "--patch-size", "8",
            "--hidden-dim", "32", "--num-layers", "1",
            "--expert-hidden-dim", "32", "--specialized-experts", "3",
            "--vision-experts", "0", "--text-experts", "0",
            "--multimodal-experts", "0", "--device", "cpu",
            "--experiments", "0,3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ablation_ranks")
    csv, imgs = generate_synthetic_vivqa(root / "d", n=40, image_size=16,
                                         seed=0, learnable=True)
    ranks = start_ranks(R.ablation_job, 2, _argv(root, csv, imgs, "ranks"))
    one = R.ablation_runs(_argv(root, csv, imgs, "one"))
    return root, one, ranks.results()


def _relative(writes: list, root: Path, name: str) -> Counter:
    return Counter(str(Path(w).relative_to(root / name)) for w in writes
                   if Path(w).is_relative_to(root / name))


def test_two_ranks_give_the_one_process_study(runs):
    """Each row completes on the mesh with the one-process run's metrics
    (f32 on both): the predictions' metrics and the per-sample mask
    equal, the telemetry's means within 1e-6, the losses within 1e-5."""
    _, one, ranks = runs
    got = {r["experiment_id"]: r for r in ranks[0]["results"]}
    want = {r["experiment_id"]: r for r in one["results"]}
    assert sorted(got) == sorted(want) == sorted(ROWS)
    for eid, w in want.items():
        g = got[eid]
        assert g["status"] == w["status"] == "completed", g["error"]
        assert g["correct_mask"] == w["correct_mask"]
        for k, v in model_metrics(w).items():
            rtol = 1e-5 if "loss" in k else 1e-6
            np.testing.assert_allclose(g["metrics"][k], v, rtol=rtol,
                                       err_msg=f"{eid} {k}")
        for h, hw in zip(g["history"], w["history"]):
            np.testing.assert_allclose(h["train_loss"], hw["train_loss"],
                                       rtol=1e-5)
        for k, v in w["moe_metrics"].items():
            np.testing.assert_allclose(g["moe_metrics"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{eid} {k}")
    # rank 1 computed the same study
    assert [model_metrics(r) for r in ranks[1]["results"]] == \
        [model_metrics(r) for r in ranks[0]["results"]]


def test_only_rank_0_writes_each_file_as_one_process_does(runs):
    """Rank 0 writes each file (results, manifest, progress, epoch
    histories, checkpoints, reports) as often as the one-process run
    does, each result JSON once; rank 1 writes none."""
    root, one, ranks = runs
    got = _relative(ranks[0]["writes"], root, "ranks")
    want = _relative(one["writes"], root, "one")
    # checkpoint directories are named by step, as one process names them
    assert got == want
    for eid in ROWS:
        assert got[f"results/{eid}.json"] == 1
        json.loads((root / "ranks" / "results" / f"{eid}.json").read_text())
    assert not _relative(ranks[1]["writes"], root, "ranks")


def test_a_second_run_resumes_and_report_only_works_on_the_mesh(runs):
    """Again with the same argv: every rank reads rank 0's results and
    trains nothing; ``--report-only`` on the mesh: rank 0 writes the
    reports, every rank returns their paths."""
    root, one, ranks = runs
    for r in ranks:
        assert r["resume_ran"] == [] and r["resumed"] == sorted(ROWS)
        assert set(r["report_only"]) == {"report", "csv", "latex",
                                         "analysis"}
        assert Path(r["report_only"]["report"]).exists()
    assert _relative(ranks[0]["report_writes"], root, "ranks") == \
        _relative(one["report_writes"], root, "one")
    assert not _relative(ranks[1]["report_writes"], root, "ranks")
