"""The port's shell wrappers, ``vivqa_tpu_torch/cli/*.sh``: the eight
scripts of ``vivqa_tpu/cli/``, each running the port's module where the
JAX one runs its own. The download scripts are only parsed here (they
need the network)."""

from __future__ import annotations

import importlib
import re
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vivqa_tpu_torch" / "cli"
JAX = ROOT / "vivqa_tpu" / "cli"
SCRIPTS = sorted(p.name for p in JAX.glob("*.sh"))


def _modules(text: str) -> set:
    """The Python modules a script runs (``python -m``) or imports."""
    return set(re.findall(r"python -m ([\w.]+)", text)) | \
        set(re.findall(r"from ([\w.]+) import", text))


# the root setup scripts' counterparts, beside the wrappers
# (tests/test_torch_setup_scripts.py)
ROOT_SCRIPTS = {"setup_pipeline.sh": "setup_vivqa_pipeline.sh",
                "quick_reference.sh": "QUICK_REFERENCE.sh"}


def test_the_port_has_every_jax_script():
    assert len(SCRIPTS) == 8
    assert sorted(p.name for p in PORT.glob("*.sh")) == sorted(
        SCRIPTS + list(ROOT_SCRIPTS))
    assert all((ROOT / jax_name).is_file()
               for jax_name in ROOT_SCRIPTS.values())


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_parses_and_runs_the_ports_modules(name):
    """``bash -n`` accepts it; it is executable; each module it names is
    the port's counterpart of the JAX script's and imports; nothing
    names the JAX package."""
    path = PORT / name
    subprocess.run(["bash", "-n", str(path)], check=True)
    assert path.stat().st_mode & 0o111
    text = path.read_text()
    assert not re.search(r"vivqa_tpu(?!_torch)[./]", text)
    mods = _modules(text)
    want = {m.replace("vivqa_tpu.", "vivqa_tpu_torch.", 1)
            for m in _modules((JAX / name).read_text())}
    assert mods == want and mods
    for m in mods:
        importlib.import_module(m)


@pytest.mark.parametrize("name", ["run_clean.sh", "run_vivqa_eval.sh"])
def test_help_exits_zero(name):
    out = subprocess.run(["bash", str(PORT / name), "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout.lower()
