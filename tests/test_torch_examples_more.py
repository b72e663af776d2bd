"""The other five walkthroughs of ``vivqa_tpu_torch/examples/`` on the CPU,
held as ``test_torch_examples.py`` holds the first five (split so that
each file runs within its time here)."""

from __future__ import annotations

import pytest

from test_torch_examples import REST, Runs, banner_titles


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("name", REST)
def test_walkthrough_exits_zero(runs, name):
    r = runs[name]
    assert r["rc"] == 0, r["stdout"][-2000:] + r["stderr"]


@pytest.mark.parametrize("name", REST)
def test_walkthrough_prints_every_section(runs, name):
    titles = banner_titles(name)
    assert titles
    missing = [t for t in titles if t not in runs[name]["stdout"]]
    assert not missing


@pytest.mark.parametrize("name", REST)
def test_walkthrough_loads_no_jax(runs, name):
    assert runs[name]["jax_modules"] == []


def test_the_ten_walkthroughs_are_the_jax_files():
    from test_torch_examples import FIRST
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    jax_files = sorted(p.stem for p in (root / "examples").glob("*.py"))
    port_files = sorted(p.stem for p in
                        (root / "vivqa_tpu_torch" / "examples").glob("*.py")
                        if p.stem != "__init__")
    assert jax_files == port_files == sorted(FIRST + REST)
