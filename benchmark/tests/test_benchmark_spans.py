"""The spans' reduction (``spans.py``) and the counter metric on the CPU:
a synthetic trace with and without the port's ``vivqa::`` annotations,
a backward kernel launched from a second thread, and a tiny generative
cell's traced run."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, run
from benchmark.spans import SpanTable
from benchmark.tests.tiny_cells import tiny_bench
from benchmark.tracing import Trace
from vivqa_tpu_torch.utils import profiling

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SEED = 2 ** 31 + 23


@dataclasses.dataclass
class Ev:
    """One raw profiler event, as ``kineto_results.events()`` gives it."""
    n: str
    start: int
    dur: int
    corr: int = 0
    dev: object = CPU
    ann: bool = False
    thread: int = 1

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def is_user_annotation(self):
        return self.ann

    def is_hidden_event(self):
        return False

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr


def _span(name, start, end):
    return Ev("vivqa::" + name, start, end - start, ann=True)


SPANS = [_span("train_step", 0, 1000), _span("forward", 10, 300),
         _span("model", 20, 250), _span("loss", 260, 290),
         _span("backward", 310, 700), _span("optimizer", 710, 990),
         _span("update", 800, 980),
         # kineto's device-side copy of an annotation
         Ev("vivqa::forward", 100, 220, dev=CUDA, ann=True)]
WORK = [
    Ev("aten::mm", 30, 30), Ev("cudaLaunchKernel", 40, 5, corr=1),
    Ev("aten::copy_", 265, 15), Ev("cudaMemcpyAsync", 270, 5, corr=2),
    # autograd's device thread, while the main thread is in ``backward``
    Ev("aten::mm", 390, 30, thread=2),
    Ev("cudaLaunchKernel", 400, 5, corr=3, thread=2),
    Ev("aten::_foreach_mul_", 715, 20),
    Ev("cudaLaunchKernel", 720, 5, corr=4),
    Ev("aten::_foreach_add_", 845, 20),
    Ev("cudaLaunchKernel", 850, 5, corr=5),
    Ev("gemm", 100, 50, corr=1, dev=CUDA),
    Ev("Memcpy DtoD", 300, 20, corr=2, dev=CUDA),
    Ev("gemm_bwd", 450, 100, corr=3, dev=CUDA),
    Ev("foreach_mul", 760, 30, corr=4, dev=CUDA),
    Ev("foreach_add", 870, 40, corr=5, dev=CUDA)]


def _reduced(events) -> Trace:
    tr = Trace("cpu")
    tr._reduce(events)
    return tr


def test_annotations_leave_the_trace_reduction_as_it_was():
    plain, spanned = _reduced(WORK), _reduced(SPANS + WORK)
    for attr in ("busy_s", "launches", "kernels", "breakdown"):
        assert getattr(spanned, attr) == getattr(plain, attr), attr
    assert plain.launches == 4 and plain.busy_s == 240e-9


def test_device_work_lands_in_the_spans_by_launch_time():
    table = SpanTable(SPANS + WORK)
    got = {name: (r["device_ns"], r["self_ns"], r["launches"], r["idle_ns"])
           for name, r in table.table.items()}
    assert got == {"train_step": (240, 0, 4, 570),
                   "forward": (70, 0, 1, 150), "model": (50, 50, 1, 0),
                   "loss": (20, 20, 0, 150),
                   "backward": (100, 100, 1, 130),
                   "optimizer": (70, 30, 2, 290),
                   "update": (40, 40, 1, 80)}
    assert table.table["forward"]["calls"] == 1
    assert table.table["forward"]["host_ns"] == 290
    assert table.busy_ns == 240
    assert (table.checked, table.early) == (5, 0)
    assert table.readings("train", 2) == {"forward_ms": 35e-6,
                                          "backward_ms": 50e-6,
                                          "optimizer_ms": 35e-6}
    assert table.readings("infer", 1) == {"forward_ms": 50e-6}
    assert table.top_ops(1, 1) == {
        "model": [["gemm", 50e-6]], "loss": [["Memcpy DtoD", 20e-6]],
        "backward": [["gemm_bwd", 100e-6]],
        "optimizer": [["foreach_mul", 30e-6]],
        "update": [["foreach_add", 40e-6]]}
    assert sorted(table.leads) == [20, 30, 40, 50, 60]
    line = table.line(1)
    assert line.startswith("spans (per call of 1): train_step x1 host 0.00")
    assert "backward x1" in line


def test_no_spans_no_readings_and_early_starts_counted():
    table = SpanTable(WORK)
    assert table.table == {} and table.checked == 0
    assert table.readings("train", 4) == dict.fromkeys(
        ("forward_ms", "backward_ms", "optimizer_ms"))
    assert table.readings("infer", 4) == {"forward_ms": None}
    early = [Ev("cudaLaunchKernel", 40, 5, corr=1),
             Ev("gemm", 35, 50, corr=1, dev=CUDA), _span("forward", 30, 60)]
    assert (SpanTable(early).checked, SpanTable(early).early) == (1, 1)


def test_counter_metric_reads_the_program_counters():
    read = harness.metric_reader("answer_rows_useful_pct.train",
                                 harness.BENCH_DIR)
    profiling.reset_counters()
    assert read({}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("decoder.positions", 16384)
        profiling.count("decoder.labelled", torch.tensor(2302))
    assert read({}) == pytest.approx(14.0503, abs=1e-4)
    profiling.reset_counters()


def test_tiny_generative_traced_run_reports_the_useful_rows(tmp_path):
    """Answers of 1-6 tokens and EOS over 8 positions at batch 8: 34 of
    64 rows a batch carry a label."""
    bench = tiny_bench(tmp_path)
    profiling.reset_counters()
    out = run.run_cell("tiny-gen-train-b512", SEED, 0.3, True, "cpu", 0.0,
                       bench_dir=bench, root=bench.parent)
    profiling.reset_counters()
    assert out["correct"] is True, out["check"]
    assert out["metrics"]["answer_rows_useful_pct.train"]["value"] \
        == pytest.approx(100 * 34 / 64)
