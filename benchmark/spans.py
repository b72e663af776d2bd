"""The port's spans in a traced window: device time, launches and idle
time put down to the ``vivqa::`` spans that launched them.

The port opens its spans (``vivqa_tpu_torch/utils/profiling.py:span``)
only while a profiler records; each is a kineto user annotation on the
host, on the clock of the device events in the same trace. A device
operation belongs to the spans open, on any thread, when the runtime
call that launched it started, and to the innermost of them as self
time: time and not thread, because autograd's device thread launches
the backward's kernels while the main thread sits inside ``backward``.

``SpanTable(events)`` reduces a window's raw events. ``Trace`` drops its
events once it has reduced them, so this command runs a cell as
``run.py --trace 1`` does, with every ``Trace`` also keeping a
``SpanTable`` as ``spans``:

    python3 benchmark/spans.py --workload cls-train-b512 --seed <n> \\
        --seconds <s>

After the cell's own result line it prints a ``spans:`` line to standard
error (each span per traced call: calls, host ms, device ms and its self
part, launches, idle ms before its operations) and one JSON line: the
same table, the device busy ms per call, the readings (``forward_ms``,
``backward_ms`` and ``optimizer_ms`` of a train step; ``forward_ms`` of
a batch, the span ``model``), the share of busy time they cover, how many
attributed operations started before the call that launched them (none
may, where the device's and the host's timestamps share one clock) and
the least, 1st percentile and median of start less launch, in us, and
the device operations that took most of each span's self time.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark.tracing import LAUNCH_CALLS  # noqa: E402

PREFIX = "vivqa::"
FIELDS = ("calls", "host_ns", "device_ns", "self_ns", "launches", "idle_ns")
# the spans each reading sums, by the cell's driver
READINGS = {"train": {"forward_ms": "forward", "backward_ms": "backward",
                      "optimizer_ms": "optimizer"},
            "infer": {"forward_ms": "model"}}


class SpanTable:
    """Per span name (without ``vivqa::``): ``calls``, ``host_ns`` (the
    spans' own durations), ``device_ns`` (operations launched inside it,
    its child spans included), ``self_ns`` (those launched with it the
    innermost open span), ``launches`` (the runtime's and driver's launch
    calls inside it) and ``idle_ns`` (the gaps in the device's busy time
    just before an operation launched inside it). Besides: ``busy_ns``,
    the union of every device operation's interval, as ``Trace`` takes
    it; ``checked``, the operations put down to some span, ``early``,
    those of them that started on the device before their launch call,
    ``leads``, each one's start less its launch call's, and ``by_op``,
    each span's self time by device operation name."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        spans, ops, launch_at, launch_calls = [], [], {}, []
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if not (e.is_user_annotation() or e.is_hidden_event()):
                    ops.append((e.start_ns(), e.duration_ns(),
                                e.correlation_id(), name))
            elif name.startswith(("cuda", "cu")):
                launch_at[e.correlation_id()] = e.start_ns()
                if name in LAUNCH_CALLS:
                    launch_calls.append(e.start_ns())
            elif e.is_user_annotation() and name.startswith(PREFIX):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name[len(PREFIX):]))
        ops.sort()
        self.table: dict = {}
        for s, e, name in spans:
            row = self._row(name)
            row["calls"] += 1
            row["host_ns"] += e - s
        op_launch = [launch_at.get(op[2]) for op in ops]
        open_at_op = _open_at(spans, op_launch)
        for names in _open_at(spans, launch_calls):
            for n in set(names):
                self._row(n)["launches"] += 1
        self.busy_ns, end = 0, None
        self.checked = self.early = 0
        self.leads: list = []
        self.by_op: dict = {}
        for (s, dur, _, op), t, names in zip(ops, op_launch, open_at_op):
            e = s + dur
            gap = 0
            if end is None or s >= end:
                gap = 0 if end is None else s - end
                self.busy_ns += dur
                end = e
            elif e > end:
                self.busy_ns += e - end
                end = e
            if not names:
                continue
            self.checked += 1
            self.early += s < t
            self.leads.append(s - t)
            for n in set(names):
                row = self._row(n)
                row["device_ns"] += dur
                row["idle_ns"] += gap
            self._row(names[-1])["self_ns"] += dur
            own = self.by_op.setdefault(names[-1], {})
            own[op] = own.get(op, 0) + dur

    def _row(self, name: str) -> dict:
        return self.table.setdefault(name, dict.fromkeys(FIELDS, 0))

    def per_call(self, calls: int) -> dict:
        """{span: {calls, host_ms, device_ms, self_ms, launches,
        idle_ms}}, each per traced call."""
        return {name: {k.replace("_ns", "_ms"):
                       v / calls / (1e6 if k.endswith("_ns") else 1)
                       for k, v in row.items()}
                for name, row in self.table.items()}

    def readings(self, driver: str, calls: int) -> dict:
        """The driver's readings in ms per call, None where the span is
        absent or launched nothing on the device."""
        out = {}
        for reading, name in READINGS[driver].items():
            ns = self.table.get(name, {}).get("device_ns")
            out[reading] = ns / calls / 1e6 if ns else None
        return out

    def top_ops(self, calls: int, n: int = 3) -> dict:
        """{span: [[operation name, ms per call]]}, the ``n`` operations
        that took most of the span's self time."""
        return {name: [[op[:80], ns / calls / 1e6] for op, ns in sorted(
                    own.items(), key=lambda kv: -kv[1])[:n]]
                for name, own in self.by_op.items()}

    def line(self, calls: int) -> str:
        """The ``spans:`` line: each span per traced call, by device
        time."""
        rows = sorted(self.per_call(calls).items(),
                      key=lambda kv: -kv[1]["device_ms"])
        return f"spans (per call of {calls}): " + ", ".join(
            f"{name} x{r['calls']:g} host {r['host_ms']:.2f} device "
            f"{r['device_ms']:.2f} self {r['self_ms']:.2f} launches "
            f"{r['launches']:g} idle {r['idle_ms']:.2f}"
            for name, r in rows)


def _open_at(spans: list, times: list) -> list:
    """For each of ``times`` (None: not traced), the names of the spans
    open then, outermost first: a sweep over the spans' starts and ends
    in time order (of two starts at one time the longer span first), a
    time at a span's start or end counting as inside it."""
    points = [(s, 0, s - e, k) for k, (s, e, _) in enumerate(spans)]
    points += [(e, 2, 0, k) for k, (_, e, _) in enumerate(spans)]
    points += [(t, 1, 0, j) for j, t in enumerate(times) if t is not None]
    points.sort()
    out = [[] for _ in times]
    open_: dict = {}
    for _, kind, _, i in points:
        if kind == 0:
            open_[i] = spans[i][2]
        elif kind == 2:
            del open_[i]
        else:
            out[i] = list(open_.values())
    return out


def _quantiles(values: list) -> dict:
    """The least, 1st percentile and median of ``values`` (ns) in us."""
    v = sorted(values)
    if not v:
        return {}
    return {q: v[int(f * (len(v) - 1))] / 1e3
            for q, f in (("min", 0.0), ("p1", 0.01), ("median", 0.5))}


def main(argv=None) -> int:
    import json

    from benchmark import harness, run
    from benchmark.tracing import Trace
    argv = list(sys.argv[1:] if argv is None else argv)
    traces = []
    reduce = Trace._reduce

    def reduce_and_keep(self, events):
        events = list(events)
        reduce(self, events)
        self.spans = SpanTable(events)
        traces.append(self)
    Trace._reduce = reduce_and_keep
    rc = run.main(argv + ["--trace", "1"])
    if rc or not traces:
        return rc or 1
    cell = harness.load_cell(argv[argv.index("--workload") + 1])
    driver = cell.workload["driver"]
    calls = cell.workload["traced_steps" if driver == "train"
                          else "traced_batches"]
    table = traces[-1].spans
    print(table.line(calls), file=sys.stderr, flush=True)
    readings = table.readings(driver, calls)
    busy_ms = table.busy_ns / calls / 1e6
    covered = sum(v for v in readings.values() if v is not None)
    print(json.dumps({
        "workload": cell.name, "calls": calls,
        "spans": table.per_call(calls), "busy_ms": busy_ms,
        "readings": readings,
        "covered_pct": 100.0 * covered / busy_ms if busy_ms else None,
        "checked_ops": table.checked, "early_ops": table.early,
        "lead_us": _quantiles(table.leads),
        "top_ops": table.top_ops(calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
