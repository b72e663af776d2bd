"""Training cells: the program's ``make_train_step`` with its loss and its
AdamW, closed loop over a ring of batches on the device.

Set-up builds one train state (the model with the seed's weights, the
optimizer, the dropout seed) and drives it through ``setup_steps`` steps
of the very call the window makes, on distinct batches: the first
``checked_steps`` are held against the reference, and the rest warm up.
The window then steps until ``seconds`` have passed on the host clock
and ends in a synchronize: the rate is every step's rows over the
window's seconds. After the window (and, with ``trace``, a traced
window of ``traced_steps`` steps) the program's state is freed and the
reference repeats the checked steps in float32.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time

import torch

from benchmark import compare, counts, harness
from benchmark.reference.layers import Precision, fold_in
from benchmark.reference.train import leaf_norms, train_steps
from benchmark.tracing import Trace
from benchmark.traffic import make_ring, resolve
from benchmark.weights import load, make_weights

DROPOUT_STREAM = 3


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_step(cell, model):
    """The program's optimizer and ``train_step`` as the workload sets
    them."""
    from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  SchedulerConfig,
                                                  create_optimizer)
    from vivqa_tpu_torch.train.state import make_train_step
    w = cell.workload
    o = w["optimizer"]
    optimizer = create_optimizer(
        OptimizerConfig(name="adamw", learning_rate=o["learning_rate"],
                        weight_decay=o["weight_decay"], beta1=o["beta1"],
                        beta2=o["beta2"], eps=o["eps"],
                        grad_clip_norm=o["grad_clip_norm"]),
        model, SchedulerConfig(name="warmup_cosine",
                               warmup_steps=o["warmup_steps"],
                               total_steps=o["total_steps"]))
    loss = w["loss"]
    loss_fn = getattr(importlib.import_module(loss["module"]),
                      loss["function"])(**loss["kwargs"])
    return optimizer, make_train_step(loss_fn)


def reference_loss(cell) -> dict:
    return {k: resolve(v, cell.model_config)
            for k, v in cell.workload["reference_loss"].items()}


def reference_steps(cell, seed: int, batches: list, shapes, device,
                    precision: str = "float32") -> dict:
    """The reference's checked steps from the seed's weights, on
    ``batches``, in ``precision`` (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = harness.reference_module(cell).Model(
            cell.model_config, Precision(precision))
    load(model, make_weights(shapes, seed, device))
    return train_steps(model, batches, fold_in(seed, DROPOUT_STREAM),
                       reference_loss(cell), cell.workload["optimizer"],
                       cell.workload["reference_block"])


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    from vivqa_tpu_torch.train.state import TrainState
    w, cfg = cell.workload, cell.model_config
    B, R = cell.traffic["batch"], cell.traffic["ring"]
    checked, setup_steps = w["checked_steps"], w["setup_steps"]
    if setup_steps < checked or R < checked:
        raise ValueError("setup_steps and the ring must cover the checked "
                         "steps")
    clock = harness.SetupClock(time.perf_counter())
    model = harness.program_model(cell, device)
    clock.mark("model")
    shapes = harness.parameter_shapes(cell)
    load(model, make_weights(shapes, seed, device))
    optimizer, train_step = program_step(cell, model)
    step_seed = fold_in(seed, DROPOUT_STREAM)
    state = TrainState.create(model, optimizer, seed=step_seed)
    clock.mark("weights and optimizer")
    ring = make_ring(cell.traffic, cfg, seed, device)
    clock.mark("inputs")

    # the first steps, through the window's own call
    b1 = w["optimizer"]["beta1"]
    start = [p.detach().clone() for p in optimizer.params]
    losses = []
    for i in range(setup_steps):
        state, metrics = train_step(state, ring[i % R])
        if i < checked:
            losses.append(metrics["loss"])
        if i == 0:
            first = dict(zip(optimizer.names, [
                n / (1 - b1) for n in leaf_norms(optimizer.state["mu"])]))
        if i == checked - 1:
            change = dict(zip(optimizer.names, leaf_norms(
                p.detach() - s for p, s in zip(optimizer.params, start))))
            del start
        if i == 0:
            _sync(device)
            clock.mark("first step")
    prog = {"losses": [float(x) for x in losses], "first_grad": first,
            "change": change}
    _sync(device)
    clock.mark("later steps")
    setup_s = time.perf_counter() - t0
    clock.log()
    _log(f"set-up {setup_s:.2f} s")

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    step_losses, n = [], 0
    t_start = time.perf_counter()
    while True:
        state, metrics = train_step(state, ring[(setup_steps + n) % R])
        step_losses.append(metrics["loss"])
        n += 1
        if time.perf_counter() - t_start >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum())

    _log(f"window {window_s:.2f} s, {n} calls")
    tr = None
    if trace:
        with Trace(device) as tr:
            for i in range(w["traced_steps"]):
                state = train_step(state, ring[i % R])[0]
    del state, model, optimizer, metrics, step_losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_steps(cell, seed, ring[:checked], shapes, device)
    _log(f"reference {time.perf_counter() - t_ref:.2f} s")
    numbers = compare.train_numbers(prog, ref)
    _log(f"worst leaves: {compare.worst_leaves(prog, ref)}")
    correct, check = compare.judge(numbers, w["limits"])

    out = {"correct": correct, "check": check, "attempted": n,
           "reference": ref,
           "failed": failed, "memory_peak_bytes": peak,
           "end_to_end": {
               "train_samples_per_s": n * B / window_s,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if tr is not None:
        c = counts.model_counts(harness.reference_module(cell), cfg, ring[0],
                                harness.mask_fields(cell.traffic), True,
                                reference_loss(cell))
        out["trace"] = tr
        out["context"] = {
            "trace": tr, "traced_calls": w["traced_steps"],
            "window_calls": n, "window_s": window_s,
            "flops_per_call": c["flops"],
            "attention": counts.attention_bounds(c["attention"], True)}
    return out
