"""The harness: a cell found by name, its program and reference built from
the cell's files, the driver run, the result line assembled.

Everything that belongs to one cell is a file found by its name:

- ``workloads/<cell>.json``: the configuration's and the traffic's
  names, the driver (``drivers/<driver>.py``), the driver's settings
  and the limits of the numbers that decide ``correct``;
- ``configs/<config>.json``: the program's configuration (``config``),
  the program's model class (``program``), the plain reference's module
  (``reference``), the published source and what was assumed;
- ``traffic/<mix>.json``: the parameters ``traffic.make_ring`` reads;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None where it finds nothing to read.

``BENCHMARK.json`` at the root says which metrics a cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vivqa_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict        # the configuration file
    traffic: dict

    @property
    def model_config(self) -> dict:
        return self.config["config"]


class SetupClock:
    """The seconds of each part of set-up, logged to standard error so
    that a set-up that swings from run to run shows which part moved."""

    def __init__(self, start: float):
        self.last = start
        self.parts: list = []

    def mark(self, part: str, now: Optional[float] = None) -> None:
        """``part`` ended at ``now`` (the host clock's present by
        default)."""
        now = time.perf_counter() if now is None else now
        self.parts.append((part, now - self.last))
        self.last = now

    def log(self) -> None:
        print("set-up parts: " + ", ".join(
            f"{part} {s:.2f}" for part, s in self.parts),
            file=sys.stderr, flush=True)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    bench_dir = Path(bench_dir)
    path = bench_dir / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload '{name}' ({path})")
    w = read_json(path)
    return Cell(name, w,
                read_json(bench_dir / "configs" / f"{w['config']}.json"),
                read_json(bench_dir / "traffic" / f"{w['traffic']}.json"))


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def program_model(cell: Cell, device) -> torch.nn.Module:
    """The program's model, built on ``device`` from the configuration
    (its own init is overwritten by ``weights.load``)."""
    if torch.device(device).type in ("cuda", "cpu"):
        # the port's entry points pick the device so, which also fixes
        # its float32 products in full float32
        from vivqa_tpu_torch.device import resolve_device
        device = resolve_device(device)
    p = cell.config["program"]
    cfg_cls = getattr(importlib.import_module(p["config_module"]),
                      p["config_class"])
    model_cls = getattr(importlib.import_module(p["module"]), p["class"])
    with torch.device(device):
        model = model_cls(cfg_cls.from_dict(cell.model_config))
    return model.to(device)


def reference_module(cell: Cell):
    return importlib.import_module(cell.config["reference"])


def parameter_shapes(cell: Cell) -> list:
    """[(name, shape)] of the reference's parameters, which the program
    shares by name."""
    with torch.device("meta"):
        model = reference_module(cell).Model(cell.model_config)
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def mask_fields(traffic: dict) -> set:
    return {f["mask"] for f in traffic["fields"] if "mask" in f}


def metric_reader(name: str, bench_dir: Path):
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(cell: Cell, kind: str, root: Path) -> Optional[list]:
    """The names of the ``kind`` ("end_to_end" or "per_layer") metrics
    that BENCHMARK.json gives this cell, or None where it lists no such
    cell (a cell being tried out reports all it has)."""
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        return None
    bench = read_json(path)
    if cell.name not in {w["name"] for w in bench["workloads"]}:
        return None
    return [m["name"] for m in bench[kind]
            if cell.name in m.get("workloads", [cell.name])]


def per_layer_units(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        return {}
    return {m["name"]: m["unit"] for m in read_json(path)["per_layer"]}
