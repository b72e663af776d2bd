"""The port's root setup scripts, ``vivqa_tpu_torch/cli/setup_pipeline.sh``
and ``quick_reference.sh`` (counterparts of ``setup_vivqa_pipeline.sh``
and ``QUICK_REFERENCE.sh``): the offline bootstrap runs its stages on the
CPU with a tiny model, and every script and module the reference names
exists. No JAX here."""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from vivqa_tpu_torch.models.config import (FusionConfig, MoEModelConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig)
from vivqa_tpu_torch.pipelines import ModelPipelineConfig, VQAPipelineConfig

ROOT = Path(__file__).resolve().parents[1]
CLI = ROOT / "vivqa_tpu_torch" / "cli"


def _env() -> dict:
    # one thread a process: the suite's workers run beside each other,
    # and torch's default of a thread a core oversubscribes the host
    return {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


def _tiny_yaml(path: Path) -> Path:
    """A classification model small enough for a CPU smoke run (the
    setup script's flags give the data's sizes)."""
    VQAPipelineConfig(model=ModelPipelineConfig(
        model=VQAModelConfig(
            visual=VisualEncoderConfig(image_size=64, patch_size=16,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2),
            text=TextEncoderConfig(vocab_size=512, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8),
            fusion=FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1),
            moe=MoEModelConfig(use_moe=False)),
        device="cpu")).to_yaml(str(path))
    return path


@pytest.mark.parametrize("name", ["setup_pipeline.sh", "quick_reference.sh"])
def test_script_parses_and_is_executable(name):
    path = CLI / name
    subprocess.run(["bash", "-n", str(path)], check=True)
    assert path.stat().st_mode & 0o111
    assert not re.search(r"vivqa_tpu(?!_torch)[./]", path.read_text())


def test_setup_help_prints_its_stages():
    out = subprocess.run(["bash", str(CLI / "setup_pipeline.sh"), "--help"],
                         capture_output=True, text=True, env=_env(),
                         check=True).stdout
    for stage in ("Environment check", "Data", "Model", "Smoke run",
                  "Evaluation", "--synthetic"):
        assert stage in out


def test_setup_synthetic_runs_every_offline_stage(tmp_path):
    """``--synthetic --device cpu`` with a tiny model: stage 1 reports
    torch and the card (none here), stage 2 writes the corpus, stage 3
    is skipped without ``--model``, stage 4 trains one epoch and stage 5
    evaluates from its checkpoint."""
    cfg = _tiny_yaml(tmp_path / "tiny.yaml")
    res = subprocess.run(
        ["bash", str(CLI / "setup_pipeline.sh"), "--synthetic",
         "--device", "cpu", "--config", str(cfg)],
        cwd=tmp_path, capture_output=True, text=True, env=_env(),
        timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = res.stdout
    for n in range(1, 6):
        assert f"Stage {n}/5" in out
    assert "torch " in out and "card: none" in out
    assert "synthetic corpus ready" in out
    assert "no --model given" in out
    assert "smoke train run OK" in out and "evaluation complete" in out
    assert (tmp_path / "data" / "synthetic" / "data.csv").is_file()
    assert (tmp_path / "outputs" / "setup" / "smoke" /
            "pipeline_summary.json").is_file()
    assert (tmp_path / "outputs" / "setup" / "eval").is_dir()
    assert (tmp_path / "checkpoints" / "vqa").is_dir()


def test_quick_reference_names_only_what_exists():
    """Every command it prints runs one of the port's scripts or modules,
    and each of those, and each config file it names, exists."""
    out = subprocess.run(["bash", str(CLI / "quick_reference.sh")],
                         capture_output=True, text=True, check=True).stdout
    commands = [line for line in out.splitlines()
                if line.startswith(("bash ", "python "))]
    assert len(commands) >= 20
    for cmd in commands:
        script = re.match(r"bash (vivqa_tpu_torch/cli/[\w]+\.sh)", cmd)
        module = re.match(r"python -m (vivqa_tpu_torch[\w.]*)", cmd)
        assert script or module, cmd
        if script:
            assert (ROOT / script.group(1)).is_file(), cmd
        else:
            assert importlib.util.find_spec(module.group(1)), cmd
    for cfg in set(re.findall(r"configs/[\w]+\.yaml", out)):
        assert (ROOT / cfg).is_file(), cfg
    assert not re.search(r"vivqa_tpu(?!_torch)[./]", out)
