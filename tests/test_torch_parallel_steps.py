"""The classification CLI's pipeline on a 2-rank gloo group (the mesh
(2, 1) that ``ModelPipelineConfig.mesh``'s default gives two launched
ranks) against the same pipeline on one process: one epoch of training,
validation and the final evaluation of the best checkpoint, in f32 and
at dropout 0. The ranks are spawned once for the module and run while
the one-process pipeline runs here."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from test_torch_support import small_cls_config
from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.parallel.launch import start_ranks
from vivqa_tpu_torch.pipelines.data_pipeline import DataPipelineConfig
from vivqa_tpu_torch.pipelines.model_pipeline import ModelPipelineConfig
from vivqa_tpu_torch.pipelines.training_pipeline import TrainingPipelineConfig
from vivqa_tpu_torch.pipelines.vqa_pipeline import VQAPipelineConfig
from vivqa_tpu_torch.train.optimizers import OptimizerConfig

torch.set_num_threads(1)

# the leaves whose exact gradient is 0: a shift a softmax ignores
ZERO_GRAD = ("key.bias", "att_fc2.bias")


def pipeline_config(root: Path, name: str, csv, imgs) -> VQAPipelineConfig:
    model = small_cls_config(PC)
    return VQAPipelineConfig(
        mode="train",
        data=DataPipelineConfig(csv_path=str(csv), image_dir=str(imgs),
                                image_size=16, max_question_length=8,
                                batch_size=8, augmentation_strength="light",
                                seed=0),
        model=ModelPipelineConfig(model=model, device="cpu", seed=0,
                                  validate_forward=False),
        training=TrainingPipelineConfig(
            num_epochs=1, checkpoint_dir=str(root / name / "ckpt"),
            optimizer=OptimizerConfig(learning_rate=1e-3), log_every=1,
            num_display_samples=0, seed=0),
        output_dir=str(root / name / "out"), seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_pipeline")
    csv, imgs = generate_synthetic_vivqa(root / "data", n=48, image_size=16,
                                         learnable=True, seed=0)
    ranks = start_ranks(R.pipeline_job, 2,
                        pipeline_config(root, "mesh", csv, imgs))
    one = R.run_pipeline(pipeline_config(root, "one", csv, imgs))
    return root, one, ranks.results()


def _numbers(record: dict) -> dict:
    return {k: v for k, v in record.items()
            if isinstance(v, (int, float)) and k != "qa_pairs_per_sec"}


def test_data_parallel_pipeline_matches_one_process(runs):
    """Every epoch's training loss, validation loss and metric, and the
    final evaluation of the best checkpoint, as on one process (each rank
    trains its half of every batch and gathers the validation logits)."""
    _, one, mesh = runs
    for got in mesh:
        assert len(got["history"]) == len(one["history"]) == 1
        for g, w in zip(got["history"] + [got["final_metrics"]],
                        one["history"] + [one["final_metrics"]]):
            g, w = _numbers(g), _numbers(w)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)


def test_only_rank_zero_writes(runs):
    """The mesh run's output holds one summary, one statistics file and
    one log (rank 0's), and one checkpoint, written from the gathered
    parameters in the single-card format: the one-process run's
    parameters."""
    root, _, _ = runs
    out = root / "mesh" / "out"
    assert sorted(p.name for p in out.iterdir()) == [
        "logs", "pipeline_summary.json", "run_stats.json"]
    assert len(list((out / "logs").iterdir())) == 1
    steps = [p for p in (root / "mesh" / "ckpt").iterdir() if p.is_dir()]
    assert len(steps) == 1
    saved = torch.load(steps[0] / "state.pt", weights_only=True)["params"]
    one = torch.load(next((root / "one" / "ckpt").glob("*/state.pt")),
                     weights_only=True)["params"]
    assert sorted(saved) == sorted(one)
    # an attention key bias and AttFlat's score bias have an exact
    # gradient of 0 (a softmax ignores a shift), so Adam turns its rounding noise into steps of up to the
    # learning rate: it is held to that bound over the run's steps; no
    # other element tighter than 1e-5 of the largest of all
    top = max(float(w.abs().max()) for w in one.values())
    lr_bound = 4 * 1e-3         # 4 steps (38 samples at batch 8) at 1e-3
    for n, w in one.items():
        assert saved[n].shape == w.shape
        atol = lr_bound if n.endswith(ZERO_GRAD) else 1e-5 * top
        torch.testing.assert_close(saved[n], w, rtol=1e-5, atol=atol, msg=n)
