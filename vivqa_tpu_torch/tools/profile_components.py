"""Step budget of the flagship classification model by component
(counterpart of tools/profile_components.py).

    python3 -m vivqa_tpu_torch.tools.profile_components [--batch 64]
        [--steps 20] [--only full,fwd,fwd_eval,fwd_bwd,opt] [--device cpu]

The model, batch, loss and optimizer are the JAX tool's
(tools/profile_components.py:65-106, the same as bench.py's): CLIP-style
ViT-B/32 + PhoBERT-style text encoder, 4 + 4 MCAN, a 4-expert top-2 MoE,
1,000 answers, bf16; cross-entropy + 0.01 x the router aux loss; AdamW
at 1e-4 with warmup-cosine and global-norm clipping. Modes:

  full      the train step of ``make_train_step`` (forward, backward,
            clip, AdamW, schedule), timed by ``time_train_steps``
            (CUDA events a step, the median)
  fwd       the training forward's loss (dropout and router noise on)
  fwd_eval  the eval forward's cross-entropy
  fwd_bwd   the loss and its gradients for every parameter, no optimizer
  opt       the AdamW update alone on fixed gradients of 1e-6

``fwd``, ``fwd_eval``, ``fwd_bwd`` and ``opt`` are timed by
``time_chained`` over ``--steps`` calls (CUDA events; each call depends
on the last). Eager PyTorch keeps the host in the loop, where JAX's
chained ``fori_loop`` hid it, so on a card each mode's window is timed
a second time under torch.profiler (``profiled_window``): that window's
ms a call beside the device kernels' summed ms over the same calls
(``busy_ms``; memory copies and sets not counted) give the idle share,
and ``wall_ms`` against the profiled window shows what the profiler
costs. For ``full`` the profiled window's ms is the mean step, its
``wall_ms`` the median. Each mode also reports its attention launches a
call. The JAX tool's lines come first, then one JSON line.

Not ported: ``--threefry``, which picks a JAX PRNG implementation for
dropout (the port draws dropout from a ``torch.Generator``); and the
"tower ablation" mode its docstring names (tools/profile_components.py:11),
which no code of that tool runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
from typing import Optional, Sequence

import torch

from vivqa_tpu_torch.bench import (bench_optimizer, flagship_config,
                                   synthetic_batch)
from vivqa_tpu_torch.device import card_line, resolve_device
from vivqa_tpu_torch.models.config import VQAModelConfig
from vivqa_tpu_torch.models.layers import init_weights
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.ops import flash_attention as fa
from vivqa_tpu_torch.train.losses import cross_entropy_loss
from vivqa_tpu_torch.train.state import (TrainState, classification_loss_fn,
                                         make_train_step)
from vivqa_tpu_torch.utils.profiling import (profiled_window, time_chained,
                                             time_train_steps)

MODES = ("full", "fwd", "fwd_eval", "fwd_bwd", "opt")
AUX_WEIGHT = 0.01           # tools/profile_components.py:106


def build_model(cfg: VQAModelConfig, device: torch.device,
                seed: int = 0) -> VietnameseVQAModel:
    """The model of ``cfg`` with weights drawn by flax's laws from a
    generator of ``device`` (on the card the draw takes no host time)."""
    with device:
        model = VietnameseVQAModel(cfg)
    model = model.to(device)    # buffers made from numpy stay on the CPU
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model


def loss_fn():
    """Cross-entropy + 0.01 x the router aux loss (the JAX tool's
    ``loss_fn``): ``loss_fn()(model, batch, generator) -> (loss,
    metrics)``."""
    return classification_loss_fn(aux_weight=AUX_WEIGHT)


def _launches(calls: int) -> dict:
    return {name: n / calls for name, n in fa.launch_counts.items()}


def _measure(fn, steps: int, device: torch.device, chained_args=None,
             state=None, train_step=None, data=None) -> dict:
    """One mode's window (its launches counted from 0), then on a card the
    same window again under the profiler: its ms a call beside the
    kernels' summed ms over it, and the idle share they give."""
    fa.reset_launch_counts()

    def timer(within):
        if train_step is not None:
            times = time_train_steps(train_step, state, data, steps, within)
            return times.median_ms, statistics.mean(
                times.event_ms or times.host_ms)
        ms = time_chained(fn, chained_args, steps, within) * 1e3
        return ms, ms
    wall = timer(contextlib.nullcontext())[0]
    launches = _launches(steps + (0 if train_step is not None else 1))
    window = busy = None
    if device.type == "cuda":
        window, busy = profiled_window(lambda within: timer(within)[1],
                                       steps)
    return {"wall_ms": wall, "busy_ms": busy, "profiled_window_ms": window,
            "idle_share": None if busy is None else 1 - busy / window,
            "launches_per_call": launches}


def profile(cfg: VQAModelConfig, batch: int, steps: int,
            device: torch.device, only: Optional[set] = None,
            seed: int = 0) -> dict:
    """Each wanted mode's wall ms, busy ms, idle share and launches a
    call, and the implied backward, optimizer + update and dropout
    costs."""
    want = set(MODES) if only is None else only
    model = build_model(cfg, device, seed)
    state = TrainState.create(model, bench_optimizer(model), seed=seed)
    data = synthetic_batch(cfg, batch, device)
    lossf = loss_fn()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd(pixels):
        model.train()
        return lossf(model, {**data, "pixel_values": pixels}, gen)[0]

    def fwd_eval(pixels):
        model.eval()
        out = model(pixels, data["input_ids"], data["attention_mask"])
        return cross_entropy_loss(out["logits"], data["labels"])

    def fwd_bwd(pixels):
        # eager PyTorch runs every operation it is given: the gradients
        # are computed whether or not the caller reads them
        with torch.enable_grad():
            loss = fwd(pixels)
            torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach()

    def opt(_):
        return state.optimizer.step()

    results = {}
    if "full" in want:
        train_step = make_train_step(lossf)
        train_step(state, data)             # warm-up
        results["full"] = _measure(None, steps, device, state=state,
                                   train_step=train_step, data=data)
    pixels = (data["pixel_values"],)
    for name, fn in (("fwd", fwd), ("fwd_eval", fwd_eval),
                     ("fwd_bwd", fwd_bwd)):
        if name in want:
            results[name] = _measure(fn, steps, device, pixels)
    if "opt" in want:
        for p in params:
            p.grad = torch.full_like(p, 1e-6)
        results["opt"] = _measure(opt, steps, device,
                                  (torch.zeros((), device=device),))
        state.optimizer.zero_grad()
    implied = {}
    if {"fwd", "fwd_bwd"} <= results.keys():
        implied["backward"] = (results["fwd_bwd"]["wall_ms"]
                               - results["fwd"]["wall_ms"])
    if {"full", "fwd_bwd"} <= results.keys():
        implied["opt_update"] = (results["full"]["wall_ms"]
                                 - results["fwd_bwd"]["wall_ms"])
    if {"fwd", "fwd_eval"} <= results.keys():
        implied["dropout_router_noise"] = (results["fwd"]["wall_ms"]
                                           - results["fwd_eval"]["wall_ms"])
    return {"modes": results, "implied_ms": implied}


def report(out: dict, batch: int) -> None:
    """The JAX tool's lines."""
    m, implied = out["modes"], out["implied_ms"]
    lines = (("full", "full step      "), ("fwd", "forward only   "),
             ("fwd_eval", "fwd (eval mode)"), ("fwd_bwd", "fwd + bwd      "),
             ("opt", "optimizer only "))
    for name, label in lines:
        if name in m:
            ms = m[name]["wall_ms"]
            extra = (f"   ({batch / (ms / 1e3):,.0f} QA-pairs/s)"
                     if name == "full" else "")
            print(f"{label}: {ms:8.2f} ms{extra}", flush=True)
    for key, label in (("backward", "implied backward"),
                       ("opt_update", "implied opt+update"),
                       ("dropout_router_noise", "dropout/router-noise cost")):
        if key in implied:
            print(f"{label} = {implied[key]:.2f} ms")


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[VQAModelConfig] = None) -> dict:
    """The CLI; ``cfg`` (from Python only) replaces the flagship."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--only", type=str, default="",
                    help=f"comma list of {','.join(MODES)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(MODES):
        ap.error(f"unknown modes {sorted(only - set(MODES))}")
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {kind}  B={args.batch} steps={args.steps}", flush=True)
    out = profile(cfg or flagship_config(), args.batch, args.steps, device,
                  only)
    report(out, args.batch)
    line = {"tool": "profile_components", "device": kind,
            "card": card_line() if on_card else None, "batch": args.batch,
            "steps": args.steps, **out}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
