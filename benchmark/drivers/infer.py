"""Batched inference cells: the program's eval-mode forward under no
gradient, then the softmax and the ``top_k`` answers (ids and
probabilities) read back to the host, a batch at a time, closed loop
over a ring of batches on the device.

Set-up answers every ring batch once. Each batch of the window is timed
from the call to its answers on the host; the window runs until
``seconds`` have passed. After it, ``checked_batches`` of the window's
batches, drawn from the seed, are held row by row against the
reference's float32 logits of the same inputs.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

from benchmark import compare, counts, harness
from benchmark.reference.layers import Precision, fold_in
from benchmark.reference.train import batch_rows
from benchmark.tracing import Trace
from benchmark.traffic import make_ring
from benchmark.weights import load, make_weights

SAMPLE_STREAM = 4


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def answerer(cell, model):
    """batch -> (ids (B, k), probs (B, k)) on the host."""
    w = cell.workload
    args, k = w["inputs"], w["top_k"]

    @torch.no_grad()
    def answer(batch):
        logits = model(*[batch[a] for a in args])["logits"]
        probs, ids = torch.softmax(logits.float(), dim=-1).topk(k, dim=-1)
        return ids.cpu(), probs.cpu()
    return answer


def reference_logp(cell, seed: int, ring: list, which: set, shapes, device,
                   precision: str = "float32") -> dict:
    """{ring index: the reference's log-probabilities (B, A) on the host}
    for the ring batches ``which``, in blocks of ``reference_block``
    rows, in ``precision`` (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    block = cell.workload["reference_block"]
    with torch.device(device):
        model = harness.reference_module(cell).Model(
            cell.model_config, Precision(precision))
    load(model, make_weights(shapes, seed, device))
    out = {}
    with torch.no_grad():
        for r in sorted(which):
            B = len(next(iter(ring[r].values())))
            out[r] = torch.cat([
                model.logits(batch_rows(ring[r], slice(s, s + block)))[0]
                .log_softmax(-1).cpu() for s in range(0, B, block)])
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    w, cfg = cell.workload, cell.model_config
    B, R = cell.traffic["batch"], cell.traffic["ring"]
    clock = harness.SetupClock(time.perf_counter())
    model = harness.program_model(cell, device)
    clock.mark("model")
    shapes = harness.parameter_shapes(cell)
    load(model, make_weights(shapes, seed, device))
    model.eval()
    clock.mark("weights")
    ring = make_ring(cell.traffic, cfg, seed, device)
    clock.mark("inputs")
    answer = answerer(cell, model)
    for i, batch in enumerate(ring):
        answer(batch)
        if i == 0:
            clock.mark("first batch")
    clock.mark("later batches")
    setup_s = time.perf_counter() - t0
    clock.log()
    _log(f"set-up {setup_s:.2f} s")

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    latency, answers, n = [], [], 0
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        answers.append(answer(ring[n % R]))
        latency.append(time.perf_counter() - t)
        n += 1
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = sum(int(not torch.isfinite(p).all()) for _, p in answers)

    _log(f"window {window_s:.2f} s, {n} calls")
    tr = None
    if trace:
        with Trace(device) as tr:
            for i in range(w["traced_batches"]):
                answer(ring[i % R])
    del model, answer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    picked = sorted(random.Random(fold_in(seed, SAMPLE_STREAM)).sample(
        range(n), min(w["checked_batches"], n)))
    ref_logp = reference_logp(cell, seed, ring, {i % R for i in picked},
                              shapes, device)
    rows = []
    for i in picked:
        ids, probs = answers[i]
        ref = ref_logp[i % R]
        rows += [(ids[j].numpy(), probs[j].numpy(), ref[j])
                 if j < len(ids) else None for j in range(B)]
    _log(f"reference {time.perf_counter() - t_ref:.2f} s")
    correct, check = compare.judge(compare.infer_numbers(rows), w["limits"])

    out = {"correct": correct, "check": check, "attempted": n,
           "reference": {"logp": ref_logp, "picked": picked},
           "failed": failed, "memory_peak_bytes": peak,
           "end_to_end": {
               "answers_per_s": n * B / window_s,
               "batch_latency_ms_p95": float(np.percentile(
                   np.array(latency) * 1e3, 95)),
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if tr is not None:
        c = counts.model_counts(harness.reference_module(cell), cfg, ring[0],
                                harness.mask_fields(cell.traffic), False,
                                {"label_smoothing": 0.0})
        out["trace"] = tr
        out["context"] = {
            "trace": tr,
            "traced_calls": w["traced_batches"], "window_calls": n,
            "window_s": window_s, "flops_per_call": c["flops"],
            "attention": counts.attention_bounds(c["attention"], False)}
    return out
