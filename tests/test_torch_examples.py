"""The walkthroughs of ``vivqa_tpu_torch/examples/`` on the CPU: each runs
as a user runs it (``python3 -m vivqa_tpu_torch.examples.<name> --device
cpu``) and exits 0, prints every section title of its JAX file
(``examples/<name>.py``, read with ``ast``, never run), and loads neither
JAX nor the JAX package. Each walkthrough runs once, in a subprocess, for
the three tests of it. This file holds the first five;
``test_torch_examples_more.py`` the other five."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from vivqa_tpu_torch.examples import banner_titles as titles_in

ROOT = Path(__file__).resolve().parents[1]
FIRST = ("complete_vqa_pipeline", "vivqa_examples", "ablation_study_examples",
         "fusion_examples", "generative_decoding_examples")
REST = ("image_representation_examples", "text_representation_examples",
        "knowledge_base_examples", "moe_examples",
        "resource_management_examples")

# runs the walkthrough as ``python -m`` does, then prints the loaded
# modules of JAX and of the JAX package as the last line
_RUNNER = """
import json, runpy, sys
sys.argv = [{module!r}, "--device", "cpu"]
try:
    runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
finally:
    print(json.dumps(sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "vivqa_tpu"))))
"""


def banner_titles(name: str) -> list:
    """The titles the JAX walkthrough prints with ``banner("...")``."""
    return titles_in(ROOT / "examples" / f"{name}.py")


def run_walkthrough(name: str) -> dict:
    module = f"vivqa_tpu_torch.examples.{name}"
    # one thread a process: the suite's workers run beside each other,
    # and torch's default of a thread a core oversubscribes the host
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", _RUNNER.format(module=module)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    lines = res.stdout.strip().splitlines()
    return {"rc": res.returncode, "stdout": res.stdout,
            "stderr": res.stderr[-3000:],
            "jax_modules": json.loads(lines[-1]) if lines else None}


class Runs(dict):
    """Each walkthrough's run, made the first time a test asks for it."""

    def __missing__(self, name):
        self[name] = run_walkthrough(name)
        return self[name]


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("name", FIRST)
def test_walkthrough_exits_zero(runs, name):
    r = runs[name]
    assert r["rc"] == 0, r["stdout"][-2000:] + r["stderr"]


@pytest.mark.parametrize("name", FIRST)
def test_walkthrough_prints_every_section(runs, name):
    titles = banner_titles(name)
    assert titles
    missing = [t for t in titles if t not in runs[name]["stdout"]]
    assert not missing


@pytest.mark.parametrize("name", FIRST)
def test_walkthrough_loads_no_jax(runs, name):
    assert runs[name]["jax_modules"] == []
