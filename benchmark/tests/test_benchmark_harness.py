"""The harness on the CPU: BENCHMARK.json against the contract it is held
to, every cell found by name, throwaway cells added as files only and run
at tiny widths, the result line, the faults that must turn ``correct``
false, and the imports the benchmark may not make."""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from benchmark import harness, run
from benchmark.tests.tiny_cells import tiny_bench

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_configuration_traffic_and_metric_found_by_name():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    pairs = set()
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload.get("chips", 1) == w["chips"] == 1
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        harness.reference_module(cell)
        assert (ROOT / "benchmark" / "drivers"
                / f"{cell.workload['driver']}.py").is_file()
        reported = harness.cell_metrics(cell, "end_to_end", ROOT)
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(cell, "per_layer", ROOT)
    assert len(pairs) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"], harness.BENCH_DIR))
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_parameter_counts_of_the_configurations():
    for c in BENCH["configs"]:
        cell = harness.Cell(c["name"], {}, json.loads(
            (ROOT / c["file"]).read_text()), {})
        shapes = harness.parameter_shapes(cell)
        total = sum(torch.Size(s).numel() for _, s in shapes)
        assert total == cell.config["parameters"]


@pytest.mark.parametrize("name", ["tiny-cls-train-b512",
                                  "tiny-gen-train-b512"])
def test_program_and_reference_share_parameter_names(bench, name):
    cell = harness.load_cell(name, bench)
    model = harness.program_model(cell, "cpu")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} \
        == dict(harness.parameter_shapes(cell))


@pytest.mark.parametrize("name", ["tiny-cls-train-b512",
                                  "tiny-gen-train-b512",
                                  "tiny-cls-infer-b512"])
def test_cell_added_as_files_runs(bench, name):
    out = run.run_cell(name, SEED, 0.5, False, "cpu", 0.0, bench_dir=bench,
                       root=bench.parent)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["correct"] is True, out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    line = json.loads(json.dumps(out))
    assert line["device"]["platform"] == "cpu"


def test_traced_run_line(bench):
    out = run.run_cell("tiny-cls-infer-b512", SEED, 0.3, True, "cpu", 0.0,
                       bench_dir=bench, root=bench.parent)
    assert list(out)[-2:] == ["breakdown", "check"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cls-train-b512", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(
        ["vivqa_tpu_torch.train", "jaxlib.xla", "vivqa_tpu.models", "jax",
         "flax", "jaxtyping", "numpy"]) == ["flax", "jax", "jaxlib.xla",
                                            "vivqa_tpu.models"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            found.add(node.args[0].value)
    return found


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "vivqa_tpu"), (f, mod)
            assert mod not in ("vivqa_tpu_torch.bench",
                               "vivqa_tpu_torch.bench_serving",
                               "chip_smoke", "bench", "bench_serving"), (f,
                                                                        mod)
        text = f.read_text()
        for name in ("chip_smoke.py", "bench_serving.py"):
            assert name not in text or f.parent.name == "tests", (f, name)
    for f in (ROOT / "benchmark" / "reference").rglob("*.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] != "vivqa_tpu_torch", (f, mod)
    for f in (ROOT / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        assert c["program"]["module"].split(".")[0] == "vivqa_tpu_torch"
        assert c["reference"].startswith("benchmark.reference.")


# -- faults under the timed path: each must turn ``correct`` false ----------
def _unchanged_step(loss_fn):
    def step(state, batch):
        state.model.train()
        state.optimizer.zero_grad()
        loss, metrics = loss_fn(state.model, batch, state.step_generator())
        loss.backward()
        state.step += 1
        return state, dict(metrics, loss=loss.detach(),
                           grad_norm=torch.zeros(()))
    return step


def _half_batch_step(make):
    def make_half(loss_fn):
        def half(model, batch, generator):
            rows = len(next(iter(batch.values()))) // 2
            return loss_fn(model, {k: v[:rows] for k, v in batch.items()},
                           generator)
        return make(half)
    return make_half


@pytest.mark.parametrize("name", ["tiny-cls-train-b512",
                                  "tiny-gen-train-b512"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_faults_are_not_correct(bench, monkeypatch, name, fault):
    from vivqa_tpu_torch.train import state as st
    make = _unchanged_step if fault == "unchanged_state" \
        else _half_batch_step(st.make_train_step)
    monkeypatch.setattr(st, "make_train_step", make)
    out = run.run_cell(name, SEED, 0.3, False, "cpu", 0.0, bench_dir=bench,
                       root=bench.parent)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_infer_faults_are_not_correct(bench, monkeypatch, fault):
    from vivqa_tpu_torch.models import vqa_model
    forward = vqa_model.VietnameseVQAModel.forward

    def broken(self, *args, **kwargs):
        out = dict(forward(self, *args, **kwargs))
        logits = out["logits"]
        if fault == "half_batch":
            out["logits"] = logits[: len(logits) // 2]
        else:
            out["logits"] = torch.cat([logits[:1].roll(1, -1), logits[1:]])
        return out
    monkeypatch.setattr(vqa_model.VietnameseVQAModel, "forward", broken)
    out = run.run_cell("tiny-cls-infer-b512", SEED, 0.3, False, "cpu", 0.0,
                       bench_dir=bench, root=bench.parent)
    assert out["correct"] is False, out["check"]
