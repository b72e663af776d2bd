"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program. The cell is
``benchmark/workloads/<name>.json``; its driver sets the program up from
the seed, measures for ``--seconds`` seconds, and checks what the timed
path produced against the plain reference. With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (read from a traced window after the measured one). The last
lines of standard error, and the line's last key ``check``, give each
number compared with its limit. Exits 2 without a result where the
cell's cards are missing, and 3 where a forbidden package (JAX or the
JAX package) was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
if __name__ == "__main__":
    # the checkout's root, in place of this script's folder
    sys.path[0] = str(ROOT)
    # compiled bytecode of every module imported from here on (torch's
    # too), written at a fixed path inside the checkout: where the
    # installed packages carry none, or the environment forbids writing
    # it, each run would compile them again (seconds, moved by the host)
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

T_IMPORTS = time.perf_counter()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, bench_dir: Path = harness.BENCH_DIR,
             root: Path = ROOT) -> dict:
    """The result of one run of cell ``name`` on ``device``: the line's
    keys, and ``check``."""
    cell = harness.load_cell(name, bench_dir)
    driver = importlib.import_module(f"benchmark.drivers."
                                     f"{cell.workload['driver']}")
    out = driver.run(cell, seed, seconds, trace, device, t0)
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", "count": 1,
        "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if not trace:
        wanted = harness.cell_metrics(cell, "end_to_end", root)
        units = {m["name"]: m["unit"] for m in harness.read_json(
            Path(root) / "BENCHMARK.json")["end_to_end"]} \
            if wanted is not None else {}
        for m, v in out["end_to_end"].items():
            if wanted is None or m in wanted:
                metrics[m] = {"value": v, "unit": units.get(m, "")}
    else:
        tr, ctx = out["trace"], out["context"]
        ctx["card"] = device_info["kind"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        wanted = harness.cell_metrics(cell, "per_layer", root)
        if wanted is None:
            wanted = sorted(p.stem for p in (Path(bench_dir) / "metrics")
                            .glob("*.py"))
        units = harness.per_layer_units(root)
        for m in wanted:
            value = harness.metric_reader(m, bench_dir)(ctx)
            if value is not None:
                metrics[m] = {"value": value, "unit": units.get(m, "")}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = out["trace"].breakdown
    result["check"] = out["check"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a library the program loads must not load JAX on its own
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # caches of kernels the program might compile, at fixed paths inside
    # the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    chips = harness.load_cell(args.workload).workload.get("chips", 1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA card(s); {found} found",
              file=sys.stderr)
        return 2
    clock = harness.SetupClock(T0)
    clock.mark("imports", T_IMPORTS)
    torch.empty(1, device="cuda:0")
    clock.mark("card context")
    clock.log()
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T0)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
