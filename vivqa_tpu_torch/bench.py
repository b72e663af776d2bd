"""Training benchmark of the port: QA-pairs per second of the flagship
classification train step (counterpart of the root bench.py).

    python3 -m vivqa_tpu_torch.bench
    torchrun --standalone --nproc-per-node N -m vivqa_tpu_torch.bench

Under a launcher the step is data-parallel over the N ranks, bench.py's
``MeshConfig(data_axis=n_chips, model_axis=1)``: a global batch of 128
per rank, each rank's rows, gradients averaged over 'data'; global rank
0 prints. One process is the one-card step.

The model, synthetic batch, loss and optimizer are bench.py's
(bench.py:53-110): CLIP-style ViT-B/32 + PhoBERT-style text encoder +
MCAN + dense top-2 MoE, 1,000 answers, bf16 compute, batch 128, numpy
seeds 0/1/2, cross-entropy + 0.01 x the router aux loss, AdamW at 1e-4
with warmup-cosine (100 / 10,000 steps), dropout on. After warm-up steps,
each timed step is bracketed by CUDA events and ends in a synchronize;
``step_ms`` is the median of the event times. ``mfu_pct`` is bench.py's
analytic count of the step's FLOPs (bench.py:133-154) over the time and
the card's dense bf16 peak. Every attention call must go through the
port's training kernels, or the run raises. Prints one JSON line and
writes no file.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vivqa_tpu_torch.device import card_line, resolve_device
from vivqa_tpu_torch.models.config import (FusionConfig, MoEModelConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig)
from vivqa_tpu_torch.models.vqa_model import create_vqa_model
from vivqa_tpu_torch.ops import flash_attention as fa
from vivqa_tpu_torch.parallel.mesh import MeshConfig, create_mesh
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (ShardedStep, TrainState,
                                         classification_loss_fn,
                                         make_train_step, place_state)
from vivqa_tpu_torch.utils.profiling import peak_tflops, time_train_steps

TRAIN_KERNELS = ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                 "flash_attn_bwd_dkv")


def flagship_config() -> VQAModelConfig:
    """The model of bench.py:53-64 and __graft_entry__._flagship_config."""
    return VQAModelConfig(
        visual=VisualEncoderConfig(backbone="clip", image_size=224,
                                   patch_size=32, hidden_dim=768,
                                   num_layers=12, num_heads=12),
        text=TextEncoderConfig(backbone="phobert", vocab_size=64001,
                               hidden_dim=768, num_layers=12, num_heads=12,
                               max_length=64),
        fusion=FusionConfig(fusion_type="mcan", hidden_dim=512, num_heads=8,
                            num_layers=4),
        moe=MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                           expert_hidden_dim=1024),
        num_answers=1000)


def synthetic_batch(cfg: VQAModelConfig, batch: int, device) -> dict:
    """bench.py:75-83: pixels uniform in [0, 1) (numpy seed 0), token ids
    (seed 1), an all-ones attention mask, answer labels (seed 2)."""
    S, L = cfg.visual.image_size, cfg.text.max_length
    data = {
        "pixel_values": np.random.RandomState(0).rand(batch, S, S, 3).astype(
            np.float32),
        "input_ids": np.random.RandomState(1).randint(
            0, cfg.text.vocab_size - 1, (batch, L)),
        "attention_mask": np.ones((batch, L), np.int64),
        "labels": np.random.RandomState(2).randint(0, cfg.num_answers,
                                                   (batch,))}
    return {n: torch.from_numpy(a).to(device) for n, a in data.items()}


def bench_optimizer(model, warmup_steps: int = 100):
    """bench.py:89-96: AdamW at lr 1e-4, weight decay 0.01 under the
    no-decay mask, global-norm clipping at 1.0, warmup-cosine over
    10,000 steps."""
    return create_optimizer(
        OptimizerConfig(learning_rate=1e-4), model,
        SchedulerConfig(name="warmup_cosine", warmup_steps=warmup_steps,
                        total_steps=10000))


def train_step_flops(cfg: VQAModelConfig, batch: int) -> float:
    """bench.py:133-154's analytic FLOPs of one train step: 6 x the
    forward's multiply-adds (projections, attention, MLPs, patch
    embedding, MCAN, the dense MoE, the classifier)."""
    def tower_macs(tokens, d, layers):
        return tokens * layers * (12 * d * d + 2 * tokens * d)

    L_v = (cfg.visual.image_size // cfg.visual.patch_size) ** 2 + 1
    L_t = cfg.text.max_length
    d_f = cfg.fusion.hidden_dim
    macs = (tower_macs(L_v, cfg.visual.hidden_dim, cfg.visual.num_layers)
            + L_v * 3 * cfg.visual.patch_size ** 2 * cfg.visual.hidden_dim
            + tower_macs(L_t, cfg.text.hidden_dim, cfg.text.num_layers)
            + tower_macs(L_t, d_f, cfg.fusion.num_layers)
            + tower_macs(L_v, d_f, cfg.fusion.num_layers)
            + cfg.fusion.num_layers * L_v * (4 * d_f * d_f + 2 * L_t * d_f)
            + (L_v + L_t) * cfg.moe.num_experts
            * 2 * d_f * cfg.moe.expert_hidden_dim
            + d_f * cfg.num_answers)
    return 6.0 * macs * batch


def main(steps: int = 20, warmup: int = 3, batch: int = 128) -> dict:
    """``batch`` rows per rank (bench.py's batch per chip)."""
    mesh = create_mesh(MeshConfig(data_axis=-1, model_axis=1), "cuda")
    dev = resolve_device(mesh.device)
    cfg = flagship_config()
    model = create_vqa_model(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
    state = place_state(TrainState.create(model, bench_optimizer(model),
                                          seed=0), mesh)
    train_step = ShardedStep(mesh, make_train_step(
        classification_loss_fn())).compile(state)[0]
    n_data = mesh.data.size
    data = synthetic_batch(cfg, batch * n_data, dev)
    for _ in range(warmup):
        train_step(state, data)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    times = time_train_steps(train_step, state, data, steps)
    calls = {n: fa.launch_counts[n] / steps for n in TRAIN_KERNELS}
    if fa.launch_counts["flash_attn_fwd"] or min(calls.values()) == 0:
        raise RuntimeError(f"attention did not run through the training "
                           f"kernels: {fa.launch_counts}")
    losses = [float(m["loss"]) for m in times.metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss {losses}")
    step_ms = times.median_ms
    flops = train_step_flops(cfg, batch)
    peak = peak_tflops(dev)
    out = {"metric": "train_qa_pairs_per_sec",
           "value": batch * n_data * 1e3 / step_ms,
           "unit": f"QA-pairs/sec (batch {batch} a rank on {n_data} "
                   f"rank(s), median of {steps} steps by CUDA events)",
           "mesh": mesh.shape, "backend": mesh.backend,
           "step_ms": step_ms, "step_tflops": flops / 1e12,
           "mfu_pct": (100 * flops / (step_ms * 1e-3) / (peak * 1e12)
                       if peak else None),
           "peak_tflops_bf16": peak,
           "attention_backend": "kernel",
           "attention_calls_per_step": calls,
           "loss_first_last": [losses[0], losses[-1]],
           "device": torch.cuda.get_device_name(dev), "card": card_line()}
    if mesh.is_main:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
