"""The readings that set the limits of ``correct``, for one cell, over
many seeds in one process on the card. Not run by the benchmark's runs.

For each of ``--seeds``: ``program``, the numbers of a sound run (the
cell's driver with a one-call window). For each of ``--control-seeds``
besides: ``control``, the reference computed in float8 put in the
program's place (its checked steps, or its top answers), and, for a
training cell, ``half_batch``, the reference's steps on half of each
batch, the mean taken over the rest. Prints one JSON line per reading.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6
"""

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import compare, harness  # noqa: E402
from benchmark.traffic import make_ring  # noqa: E402


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def control_readings(cell, driver, seed: int, out: dict, device) -> dict:
    """The control's numbers (and a training cell's half-batch fault's)
    against the float32 reference of the sound run ``out``."""
    cfg = cell.model_config
    ring = make_ring(cell.traffic, cfg, seed, device)
    shapes = harness.parameter_shapes(cell)
    ref = out["reference"]
    if cell.workload["driver"] == "train":
        checked = ring[:cell.workload["checked_steps"]]
        low = driver.reference_steps(cell, seed, checked, shapes, device,
                                     "float8")
        _free()
        half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in checked]
        fault = driver.reference_steps(cell, seed, half, shapes, device)
        return {"control": compare.train_numbers(low, ref),
                "half_batch": compare.train_numbers(fault, ref)}
    R = cell.traffic["ring"]
    logp = driver.reference_logp(cell, seed, ring,
                                 {i % R for i in ref["picked"]}, shapes,
                                 device, "float8")
    k = cell.workload["top_k"]
    rows = []
    for i in ref["picked"]:
        probs, ids = logp[i % R].exp().topk(k, dim=-1)
        want = ref["logp"][i % R]
        rows += [(ids[j].numpy(), probs[j].numpy(), want[j])
                 for j in range(len(ids))]
    return {"control": compare.infer_numbers(rows)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    device = "cuda:0"
    cell = harness.load_cell(args.workload)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.workload['driver']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + controls:
        t = time.perf_counter()
        out = driver.run(cell, seed, 0.05, False, device, t)
        line = {"workload": cell.name, "seed": seed,
                "program": {n: c["value"] for n, c in out["check"].items()}}
        if seed in controls:
            _free()
            line.update(control_readings(cell, driver, seed, out, device))
        del out
        _free()
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
