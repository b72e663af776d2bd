"""Drive the PyTorch port (vivqa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the port with nvcc for sm_90a, all at once,
   with ptxas' register, spill and shared-memory report;
3. kernels: each kernel against its plain version on the card at the
   shapes the serving paths give it (the classification forward's, the
   generative path's: encoders and fusion at batch 16, the single-query
   decode calls over the KV cache at several steps and over the encoder
   memory; and a few edge cases), in f32, bf16 and f16 (the serving
   forward's tensor-core template at each of its three tile sizes), one
   JSON line per case with its time (CUDA-graph replay, and the
   profiler's sum of kernel durations; at each tile size), the plain
   version's, the bound and scaled_dot_product_attention's time as a
   yardstick, and a line with the serving forward's time per flagship
   forward and per generate at each tile size; then the three training
   kernels (forward with stats, dQ, dK/dV) the same way at the training
   step's shapes (batch 128) and edge cases, with attention dropout on
   and off, o, m, l, dq, dk and dv checked in f32, bf16 and f16;
4. serving: the flagship classification model (CLIP-style ViT-B/32,
   PhoBERT-style text encoder, MCAN, dense top-2 MoE, 1,000 answers) with
   seeded random weights behind VQAPredictor, answering batches of 8
   requests with questions of different lengths; every attention call
   must go through the kernel (36 launches per forward), and one batch is
   checked against the same weights on the CPU (the plain path); then
   one batch's forward eager, as one CUDA graph, and under torch.profiler
   (the device's busy time and idle share);
5. generative serving: bench_serving's model (12 + 12 encoder layers, 3
   fusion layers, 6 decoder layers, 64,001-token vocab) with seeded
   random weights, greedy and beam (4 beams) generates of 32 tokens at
   batch 16 and 64 through build_generate_fn, timed with the port's
   bench_serving functions (answers/s, p50/p95); every attention call
   goes through the forward kernel (411 launches per generate, none of
   the training kernels); the greedy sequences against the card's own
   teacher forcing, card against CPU at batch 2, one greedy and one beam
   generate under torch.profiler;
6. training: the same classification model with bench.py's synthetic
   batch of 128, loss and optimizer (cross-entropy + 0.01 x router aux
   loss, AdamW with warmup-cosine, decay mask and global-norm clipping),
   dropout on; a few warm-up steps, then timed steps (step ms, QA-pairs/s,
   loss and grad_norm per step, peak memory); every attention call must
   go through the three training kernels (36 launches of each per step,
   none of the inference forward); one step under torch.profiler; then
   two steps of the same weights at dropout 0 on a ragged batch of 4, on
   the card and on the CPU (the plain versions), whose losses, grad norms
   and updated parameters must agree;
7. generative training (bench_convergence_gen.py's flagship mode:
   bench_serving's model, dropout 0.05, batch 32, questions of 3-60
   tokens, answers of 1-6 tokens through the port's GenerativeVQADataset
   targets, AdamW at lr 1e-3 with warmup-cosine): the three training
   kernels at the step's five shapes under its masks (the decoder's
   causal AND padding self-attention, whose rows are mostly keyless, the
   cross-attention's stride-0 query mask, the fusion's 113 x 113 q/k
   mask) against their plain versions in f32, f16 and bf16 with and
   without dropout, timed beside SDPA, and their totals per step; the
   train step timed (step ms, answer tokens/s, QA-pairs/s, peak memory;
   39 launches of each training kernel per step, none of the forward)
   and profiled; two steps card against CPU at batch 4; one short
   GenerativeTrainingPipeline.run (an epoch of 3 steps, a one-batch
   greedy validation at batch 16 through the forward kernel, a
   checkpoint that restore_best gives back bit for bit);
8. the card line (nvidia-smi's name and power limit), the kernels line,
   and the device line, which is the last line.

Each path's launch counts are set to 0 just before it runs and read just
after.
The script imports nothing of JAX or of the JAX package. Without a CUDA
device it prints no result and exits 2.
"""

from __future__ import annotations

import copy
import json
import math
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from vivqa_tpu_torch import bench, bench_serving
from vivqa_tpu_torch.bench import (bench_optimizer, flagship_config,
                                   synthetic_batch)
from vivqa_tpu_torch.data.augmentation import ImageAugmentation
from vivqa_tpu_torch.data.dataset import (IGNORE_INDEX, GenerativeVQADataset,
                                          generative_collate)
from vivqa_tpu_torch.data.schema import OneSample
from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
from vivqa_tpu_torch.device import card_line, resolve_device
from vivqa_tpu_torch.eval.predictor import VQAPredictor
from vivqa_tpu_torch.models.config import GenerativeVQAConfig, VQAModelConfig
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.models.generative import create_generative_vqa_model
from vivqa_tpu_torch.models.layers import (make_attention_mask,
                                           make_causal_mask)
from vivqa_tpu_torch.models.vqa_model import create_vqa_model
from vivqa_tpu_torch.ops import cuda_build
from vivqa_tpu_torch.ops import flash_attention as fa
from vivqa_tpu_torch.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig, GenerativeTrainingPipeline, batch_to_device)
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager)
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (TrainState, classification_loss_fn,
                                         generative_loss_fn, make_train_step)

# H100 SXM published peaks (NVIDIA data sheet, dense), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

KERNEL_SOURCES = ("flash_attn_fwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkv")
TRAIN_KERNELS = bench.TRAIN_KERNELS

# kernel vs plain version on the same inputs. bf16: the plain version
# rounds the normalised probabilities to bf16 before P.V (as
# _xla_attention does); the kernels' tensor-core templates (serving and
# training) round the unnormalised ones; both round the output to bf16
# (2**-8 relative), so a few bf16 ulps of outputs of size <= ~2. f16 has
# 3 more bits and takes the same bound. f32 (the SIMT templates): the same
# arithmetic in another order, f32 rounding only.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}

# What each launch count's kernels are called on the device (torch.profiler)
KERNEL_NAMES = {"flash_attn_fwd": "flash_attn_fwd_mma_kernel",
                "flash_attn_fwd_lse": "flash_attn_fwd_lse",
                "flash_attn_bwd_dq": "flash_attn_bwd_dq",
                "flash_attn_bwd_dkv": "flash_attn_bwd_dkv"}
# The templates each kernel runs on the main paths (bf16, head dim 64; the
# serving forward at the serving paths' tile sizes, the decoder's masked
# single-query calls at DECODE_TILE_ROWS; the calls with a mask and those
# without take separate instantiations), as ptxas names them
_BF16_64 = "I13__nv_bfloat16Li64E"
MAIN_TEMPLATES = {
    "flash_attn_fwd": [
        f"flash_attn_fwd_mma_kernel{_BF16_64}Li{rows}ELb{m}EE"
        for rows, m in ((fa.SERVING_TILE_ROWS, 0), (fa.SERVING_TILE_ROWS, 1),
                        (fa.DECODE_TILE_ROWS, 1))],
    "flash_attn_fwd_lse": [f"flash_attn_fwd_lse_mma_kernel{_BF16_64}Lb{m}EE"
                           for m in (0, 1)],
    "flash_attn_bwd_dq": [f"flash_attn_bwd_dq_mma_kernel{_BF16_64}"],
    "flash_attn_bwd_dkv": [f"flash_attn_bwd_dkv_mma_kernel{_BF16_64}Lb{m}EE"
                           for m in (0, 1)]}

# (name, B, H, Lq, Lk, D, mask kind, causal, calls per flagship forward)
ATTN_CASES = [
    ("vit_self", 8, 12, 50, 50, 64, None, False, 12),
    ("text_self", 8, 12, 64, 64, 64, "query_key", False, 12),
    ("mcan_enc_self", 8, 8, 64, 64, 64, "query_key", False, 4),
    ("mcan_dec_self", 8, 8, 49, 49, 64, None, False, 4),
    ("mcan_cross", 8, 8, 49, 64, 64, "key", False, 4),
    ("causal_lq_eq_lk", 8, 8, 64, 64, 64, None, True, 0),
    ("causal_lq_lt_lk", 8, 8, 24, 64, 64, None, True, 0),
    ("causal_lq_gt_lk", 8, 8, 64, 24, 64, None, True, 0),
    ("gen_fusion_113", 8, 8, 113, 113, 64, "key", False, 0),
    ("long_1024", 2, 8, 1024, 1024, 64, None, False, 0),
    ("head_dim_128", 8, 4, 64, 64, 128, "query_key", False, 0),
]

ATTN_CALLS_PER_FORWARD = sum(c[-1] for c in ATTN_CASES)    # 36

# The generative path's attention at bench_serving's config
# (vivqa_tpu_torch/bench_serving.py): (name, B, H, Lq, Lk, D, the path's
# mask kind, a padded mask kind checked as well, calls per beam generate
# at batch 16). That generate runs the encoders and the fusion at batch
# 16 and 32 decode steps at 16 x 4 beams = 64 rows; each step makes, per
# decoder layer, one self call over the 32-position cache (keys at
# positions <= the step: "cache_pos") and one cross call over the
# 113-token memory under its key mask. Greedy runs the steps at the
# batch, beam at batch 64 at 256 rows. bench_serving's questions have no
# padding, so the text, fusion and memory masks the path builds allow
# every key ("full_*"); each case is timed with the path's mask, and
# checked with it and with random padding. A cache_pos case is checked at
# each of CACHE_INDICES and timed at the middle one; its bytes and flops
# are the mean over a generate's steps (cur_index 0 .. Lk - 1).
GEN_CASES = [
    ("gen_vit_self", 16, 12, 50, 50, 64, None, None, 12),
    ("gen_text_self", 16, 12, 64, 64, 64, "full_query_key", "query_key",
     12),
    ("gen_fusion_self", 16, 8, 113, 113, 64, "full_query_key", "query_key",
     3),
    ("dec_self_16", 16, 8, 1, 32, 64, "cache_pos", None, 0),
    ("dec_self_64", 64, 8, 1, 32, 64, "cache_pos", None, 192),
    ("dec_self_256", 256, 8, 1, 32, 64, "cache_pos", None, 0),
    ("dec_cross_16", 16, 8, 1, 113, 64, "full_key", "key", 0),
    ("dec_cross_64", 64, 8, 1, 113, 64, "full_key", "key", 192),
    ("dec_cross_256", 256, 8, 1, 113, 64, "full_key", "key", 0),
]
CACHE_INDICES = (0, 15, 31)
GEN_HEAD = "beam_b16"          # the generate GEN_CASES' calls describe

# The training kernels against their plain versions (the backward ones fed
# the kernel forward's o, m, l). o, dq, dk and dv are held relative to
# each tensor's largest value (at least 1): dropout scales o by 1/0.9 and
# a row with few keys reaches |o| ~ 4, where a bf16 ulp is 2**-6; o as
# ATTN_TOL, the gradients as GRAD_TOL (f32 differs by summation order
# only; in bf16 both round their outputs once to bf16, 2**-8 relative).
# m and l are f32 in both (1e-5, elementwise relative). In bf16 and f16
# the dQ kernel also rounds dS to the input dtype before dS.K, which the
# plain version does not (ROADMAP.md, Queue C); the bound holds it.
STAT_TOL = 1e-5
GRAD_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-4}
TRAIN_BATCH = 128                     # bench.py's batch per chip
DROPOUT = 0.1                 # text and MCAN (models/config.py:81,97)

# (name, B, H, Lq, Lk, D, mask kind, causal, calls per flagship step, the
# dropout rate those calls use); every case runs with dropout 0 and 0.1
TRAIN_CASES = [
    ("vit_self", 128, 12, 50, 50, 64, None, False, 12, 0.0),
    ("text_self", 128, 12, 64, 64, 64, "query_key", False, 12, DROPOUT),
    ("mcan_enc_self", 128, 8, 64, 64, 64, "query_key", False, 4, DROPOUT),
    ("mcan_dec_self", 128, 8, 49, 49, 64, None, False, 4, DROPOUT),
    ("mcan_cross", 128, 8, 49, 64, 64, "key", False, 4, DROPOUT),
    ("causal_lq_eq_lk", 8, 8, 64, 64, 64, None, True, 0, None),
    ("causal_lq_lt_lk", 8, 8, 24, 64, 64, None, True, 0, None),
    ("causal_lq_gt_lk", 8, 8, 96, 24, 64, None, True, 0, None),
    ("gen_fusion_113", 8, 8, 113, 113, 64, "key", False, 0, None),
    ("long_1024", 2, 8, 1024, 1024, 64, None, False, 0, None),
    ("head_dim_128", 8, 4, 64, 64, 128, "query_key", False, 0, None),
]
ATTN_CALLS_PER_STEP = sum(c[8] for c in TRAIN_CASES)        # 36

# The generative train step (bench_convergence_gen.py:83-130's flagship
# mode): batch 32, dropout 0.05 in the fusion and the decoder (the text
# encoder keeps its config's 0.1, the ViT its 0.0), questions of 3-60
# tokens padded to 64, answers of 1-6 tokens (2-7 of the decoder's 32
# positions, BOS first).
GEN_TRAIN_BATCH = 32
GEN_DROPOUT = 0.05
# the pipeline run's validation batch: the batch at which GEN_CASES hold
# the forward kernel's encoder, fusion and decode calls, padded masks too
GEN_VAL_BATCH = GEN_CASES[0][1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of ``fn`` issued from Python, from CUDA events over
    ``iters`` back-to-back calls: at these sizes the host's dispatch, not
    the device, sets it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def device_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times, timed with CUDA events. The host's
    dispatch drops out; each launch still costs its device-side latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / calls


def profiled(fn, calls: int = 10, tries: int = 5) -> dict:
    """Device time per call of ``fn``: the sum of the durations of the
    kernels it launches, under torch.profiler, over ``calls`` calls (for
    calls whose host side, as autograd's, would set an eager rate). The
    profiler at times drops kernels, so profiles are taken until two of
    them hold the most kernels any has held (at most ``tries``); the time
    is the mean of those that hold the most. Returns ``ms``,
    ``kernels_per_call`` and ``complete`` (False when no two profiles
    agreed: the time may then be short)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof).values()
        seen.append((sum(c for c, _ in kernels), sum(t for _, t in kernels)))
        most = max(c for c, _ in seen)
        fullest = [t for c, t in seen if c == most]
        if most and len(fullest) >= 2:
            break
    if not most:
        raise AssertionError(f"torch.profiler recorded no kernel in "
                             f"{tries} tries")
    return {"ms": sum(fullest) / len(fullest) / 1e3 / calls,
            "kernels_per_call": most / calls,
            "complete": len(fullest) >= 2}


def profiled_ms(fn, calls: int = 10, tries: int = 5) -> float:
    """``profiled``'s time alone."""
    return profiled(fn, calls, tries)["ms"]


def device_kernels(prof) -> dict:
    """{kernel name: [launches, device us]} of a torch.profiler run. User
    annotations that the profiler also places on the device's timeline
    (such as ``Optimizer.step#AdamW.step``) span kernels counted already
    and are left out."""
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    return kernels


# -- phase 2: build ----------------------------------------------------------
def ptxas_usage(report: str) -> dict:
    """{mangled kernel name: {registers, spill_store_bytes,
    spill_load_bytes}} from nvcc's ``-Xptxas -v`` report."""
    usage, current = {}, None
    for line in report.splitlines():
        name = re.search(r"(?:Compiling entry function '|Function properties "
                         r"for )([^' ]+)", line)
        if name:
            current = usage.setdefault(name.group(1), {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            current["spill_store_bytes"] = int(spill.group(1))
            current["spill_load_bytes"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    return usage


def build_phase() -> dict:
    """Build every source at once; return, for each kernel of the main
    path, ptxas' usage of the template that path runs."""
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(cuda_build.build, KERNEL_SOURCES))
    usage = {}
    for name, res in zip(KERNEL_SOURCES, results):
        print(f"[build] {name}: {res.seconds:.1f} s -> {res.library.name}")
        for line in res.report.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "smem" in line) or "spill" in line:
                print(f"[build]   {line.strip()}")
        usage.update(ptxas_usage(res.report))
    out = {}
    for kernel, templates in MAIN_TEMPLATES.items():
        each = {}
        for template in templates:
            found = [u for n, u in usage.items() if template in n]
            if len(found) != 1 or "registers" not in found[0]:
                raise AssertionError(f"ptxas report has {len(found)} entries "
                                     f"for {template}")
            each[template] = found[0]
        out[kernel] = {
            "templates": each,
            **{key: max(u.get(key, 0) for u in each.values())
               for key in ("registers", "spill_store_bytes",
                           "spill_load_bytes")}}
    emit({"ptxas": out})
    return out


# -- phase 3: kernels --------------------------------------------------------
def cache_pos_mask(Lk: int, cur_index: int) -> torch.Tensor:
    """The decoder's cache at step ``cur_index``: keys <= the step."""
    return (torch.arange(Lk, device="cuda") <= cur_index).view(1, 1, 1, Lk)


def attention_inputs(B, H, Lq, Lk, D, kind, dtype, gen, cur_index=None):
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rand(B, H, Lq, D), rand(B, H, Lk, D), rand(B, H, Lk, D)
    mask = None
    if kind == "cache_pos":
        mask = cache_pos_mask(Lk, cur_index)
    elif kind == "full_key":    # make_attention_mask(None, no padding)
        mask = torch.ones(B, 1, 1, Lk, dtype=torch.bool, device="cuda")
    elif kind == "full_query_key":      # make_attention_mask(ones, ones)
        mask = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device="cuda")
    elif kind is not None:
        klen = torch.randint(1, Lk + 1, (B,), generator=gen, device="cuda")
        kv = torch.arange(Lk, device="cuda")[None] < klen[:, None]
        if kind == "key":
            qv = torch.ones(B, Lq, dtype=torch.bool, device="cuda")
        else:   # query AND key padding, as the text encoder builds it
            qv = torch.arange(Lq, device="cuda")[None] < klen[:, None]
        mask = qv[:, None, :, None] & kv[:, None, None, :]
    return q, k, v, mask


def attention_work(q, k, mask, causal):
    """(bytes moved, flops needed, key rows needed) of the call's data:
    q and o once; of k and v only the key rows that some query of the same
    (batch, head) takes (a row no query takes need not be read); the mask
    once; 4*D flops per (query, key) pair that enters the softmax. A query
    row with no allowed key averages all Lk keys, so it takes every key."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    allowed = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device=q.device)
    if causal:
        allowed = allowed & torch.ones(Lq, Lk, dtype=torch.bool,
                                       device=q.device).tril(Lk - Lq)
    if mask is not None:
        allowed = allowed & mask
    allowed = allowed | ~allowed.any(-1, keepdim=True)
    pairs = int(allowed.sum()) * H
    key_rows = int(allowed.any(2).sum()) * H
    nbytes = (2 * q.numel() + 2 * key_rows * D) * q.element_size()
    if mask is not None:
        nbytes += mask.numel()
    return nbytes, 4 * D * pairs, key_rows


def attention_case(name, B, H, Lq, Lk, D, kind, causal, gen,
                   calls_per_forward=0, calls_per_generate=0,
                   check_kind=None) -> dict:
    """One case: the forward kernel against its plain version in f32, f16
    and bf16 (bf16 and f16 at each tile size; a cache_pos case at each of
    CACHE_INDICES; with ``kind``'s mask and ``check_kind``'s), then, in
    bf16 with ``kind``'s mask, its time (graph and profiler, at each tile
    size), the plain version's, the bound and SDPA's."""
    errs = {}
    variants = [(kind, cur) for cur in
                (CACHE_INDICES if kind == "cache_pos" else (None,))]
    if check_kind is not None:
        variants.append((check_kind, None))
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        errs[dtype] = 0.0
        for mask_kind, cur in variants:
            q, k, v, mask = attention_inputs(B, H, Lq, Lk, D, mask_kind,
                                             dtype, gen, cur)
            ref = fa.attention_reference(q, k, v, mask, causal)
            tiles = (fa.serving_tile_rows(Lq),) \
                if dtype == torch.float32 else fa.TILE_ROWS
            for tile_rows in tiles:
                out = fa.flash_attention_cuda(q, k, v, mask, causal,
                                              tile_rows)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                if not math.isfinite(err) or err > ATTN_TOL[dtype]:
                    raise AssertionError(
                        f"{name} {dtype} mask {mask_kind} tile_rows "
                        f"{tile_rows} cur_index {cur}: kernel vs plain max "
                        f"|err| {err} > {ATTN_TOL[dtype]}")
                errs[dtype] = max(errs[dtype], err)
    # timing and bounds at the main path's dtype and mask, bf16 (a
    # cache_pos case at the middle index, whose mask keeps half the keys)
    q, k, v, mask = attention_inputs(
        B, H, Lq, Lk, D, kind, torch.bfloat16, gen,
        CACHE_INDICES[1] if kind == "cache_pos" else None)
    sdpa_mask = mask
    if causal:
        tri = torch.ones(Lq, Lk, dtype=torch.bool,
                         device="cuda").tril(Lk - Lq)
        sdpa_mask = tri if mask is None else mask & tri

    def kernel():
        return fa.flash_attention_cuda(q, k, v, mask, causal)

    def plain():
        return fa.attention_reference(q, k, v, mask, causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    times = {f"{label}_ms": device_ms(fn) for label, fn in
             (("plain", plain), ("library", library))}
    times.update({f"{label}_eager_ms": eager_ms(fn) for label, fn in
                  (("kernel", kernel), ("library", library))})
    for label, timer in (("kernel_ms", device_ms),
                         ("kernel_profiled_ms", profiled_ms)):
        by_tile = {
            tile_rows: timer(lambda tile_rows=tile_rows:
                             fa.flash_attention_cuda(q, k, v, mask, causal,
                                                     tile_rows))
            for tile_rows in fa.TILE_ROWS}
        times[f"{label}_by_tile_rows"] = by_tile
        times[label] = by_tile[fa.serving_tile_rows(Lq)]
    if kind == "cache_pos":     # the mean over a generate's steps
        works = [attention_work(q, k, cache_pos_mask(Lk, cur), causal)
                 for cur in range(Lk)]
        nbytes, flops = (sum(w[i] for w in works) / Lk for i in (0, 1))
    else:
        nbytes, flops, _ = attention_work(q, k, mask, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
           "mask": kind, "mask_checked_also": check_kind, "causal": causal,
           "calls_per_forward": calls_per_forward,
           "calls_per_generate": calls_per_generate,
           "max_abs_err_bf16": errs[torch.bfloat16],
           "max_abs_err_f16": errs[torch.float16],
           "max_abs_err_f32": errs[torch.float32],
           "tol_bf16": ATTN_TOL[torch.bfloat16],
           "tol_f16": ATTN_TOL[torch.float16],
           "tol_f32": ATTN_TOL[torch.float32],
           **times, "bytes": nbytes, "flops": flops,
           "bound_us": max(t_bytes, t_flops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    if kind == "cache_pos":
        row["cur_indices_checked"] = list(CACHE_INDICES)
        row["cur_index_timed"] = CACHE_INDICES[1]
        row["work_over_cur_indices"] = [0, Lk - 1]
    emit({"attention_case": row})
    return row


def kernel_phase() -> dict:
    """Rows keyed by case: the classification serving forward's cases
    (ATTN_CASES) and the generative path's (GEN_CASES). ``kernel_ms`` is
    the time at the tile size the paths use (``serving_tile_rows``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, B, H, Lq, Lk, D, kind, causal, calls in ATTN_CASES:
        rows[name] = attention_case(name, B, H, Lq, Lk, D, kind, causal, gen,
                                    calls_per_forward=calls)
    for name, B, H, Lq, Lk, D, kind, check_kind, calls in GEN_CASES:
        rows[name] = attention_case(name, B, H, Lq, Lk, D, kind, False, gen,
                                    calls_per_generate=calls,
                                    check_kind=check_kind)
    return rows


def _by_tile_sums(rows: dict, calls_key: str) -> dict:
    main = [r for r in rows.values() if r[calls_key]]
    out = {}
    for label in ("kernel_ms_by_tile_rows",
                  "kernel_profiled_ms_by_tile_rows"):
        out[label] = {t: sum(r[label][t] * r[calls_key] for r in main)
                      for t in fa.TILE_ROWS}
    ms = out["kernel_ms_by_tile_rows"]
    out["fastest"] = min(ms, key=ms.get)
    out["used_ms"] = sum(r["kernel_ms"] * r[calls_key] for r in main)
    out["used"] = sorted({fa.serving_tile_rows(r["Lq"]) for r in main})
    return out


def decode_tile_rule(rows: dict) -> dict:
    """The decode calls of one generate in each of bench_serving's four
    configurations (new tokens x decoder layers self calls over the
    cache and as many cross calls over the memory, at B rows for greedy
    and B x beams for beam) at each tile size, graph replay; their sum
    over the four, from which DECODE_TILE_ROWS is chosen; and what the
    tile used gives up in each against that configuration's fastest."""
    cfg = bench_serving.serving_config()
    calls = bench_serving.NEW_TOKENS * cfg.decoder_layers
    beams = bench_serving.decode_config("beam").num_beams
    by_config = {}
    for strategy in GEN_STRATEGIES:
        for B in GEN_BATCHES:
            R = B * (beams if strategy == "beam" else 1)
            self_ms, cross_ms = (
                rows[f"dec_{kind}_{R}"]["kernel_ms_by_tile_rows"]
                for kind in ("self", "cross"))
            by_config[f"{strategy}_b{B}"] = {
                t: calls * (self_ms[t] + cross_ms[t]) for t in fa.TILE_ROWS}
    total = {t: sum(c[t] for c in by_config.values()) for t in fa.TILE_ROWS}
    used = fa.DECODE_TILE_ROWS
    return {"calls_per_generate": 2 * calls,
            "ms_per_generate_by_tile_rows": by_config,
            "ms_all_configs_by_tile_rows": total,
            "fastest_all_configs": min(total, key=total.get), "used": used,
            "given_up_ms_per_generate": {
                k: c[used] - min(c.values()) for k, c in by_config.items()}}


def tile_rows_line(rows: dict) -> dict:
    """The serving forward's bf16 time at each tile size, graph and
    profiler: per flagship forward (its 36 calls at the five serving
    shapes), per beam generate at batch 16 (its 411 calls), per call at
    each single-query decode shape, and the decode tile rule's sums."""
    out = _by_tile_sums(rows, "calls_per_forward")
    out["generate"] = _by_tile_sums(rows, "calls_per_generate")
    out["decode_cases"] = {
        r["case"]: {"kernel_ms_by_tile_rows": r["kernel_ms_by_tile_rows"],
                    "library_ms": r["library_ms"]}
        for r in rows.values() if r["Lq"] == 1}
    out["decode_rule"] = decode_tile_rule(rows)
    return {"serving_tile_rows": out}


# -- phase 3, training kernels ----------------------------------------------
def train_attention_work(q, k, mask, causal) -> dict:
    """Bytes (each input read once, each output written once) and flops of
    each training kernel, for the (query, key) pairs the softmax takes (a
    row with no allowed key takes all Lk): the forward reads q, k, v,
    writes o, m, l, 4*D flops per pair; dQ reads q, k, v, o, dO, m, l,
    writes dq and delta, 6*D per pair (s, dP, dQ) and 2*D per row for
    delta; dK/dV reads q, k, v, dO, m, l, delta, writes dk, dv, 8*D per
    pair (s, dP, dV, dK). Of k and v each reads only the key rows some
    query takes (``attention_work``); dk and dv are written whole. The
    mask, where there is one, is read once as it is stored (a (B, 1, 1,
    Lk) key mask is B * Lk bytes: the kernels read its query axis with
    stride 0)."""
    B, H, Lq, D = q.shape
    nbytes, flops, key_rows = attention_work(q, k, mask, causal)
    pairs = flops // (4 * D)
    e, nq, nk, nk_read = q.element_size(), q.numel(), k.numel(), key_rows * D
    stats = B * H * Lq * 4
    mask_b = 0 if mask is None else mask.numel()
    return {"flash_attn_fwd_lse": (nbytes + 2 * stats, 4 * D * pairs),
            "flash_attn_bwd_dq": ((4 * nq + 2 * nk_read) * e + 3 * stats
                                  + mask_b,
                                  6 * D * pairs + 2 * D * B * H * Lq),
            "flash_attn_bwd_dkv": ((2 * nq + 2 * nk_read + 2 * nk) * e
                                   + 3 * stats + mask_b, 8 * D * pairs)}


def _grad_err(got, want) -> float:
    """max |got - want| relative to want's largest value (at least 1)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def _stat_err(got, want) -> float:
    """max |got - want| / (1 + |want|), elementwise (m is -1e30 on fully
    masked rows in both)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


def train_kernels_once(q, k, v, do, mask, causal, rate, key):
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, causal, rate,
                                              key)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, m, l, do, mask,
                                               causal, rate, key)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, m, l, do, delta, mask,
                                             causal, rate, key)
    return o, m, l, dq, dk, dv


def check_train_kernels(q, k, v, do, mask, causal, rate, key) -> dict:
    """Each training kernel against its plain version on the same inputs;
    the backward ones get the kernel forward's o, m and l."""
    dtype = q.dtype
    o, m, l, dq, dk, dv = train_kernels_once(q, k, v, do, mask, causal,
                                             rate, key)
    o_r, m_r, l_r = fa.attention_forward_lse_reference(q, k, v, mask, causal,
                                                       rate, key)
    dq_r, delta_r = fa.attention_bwd_dq_reference(q, k, v, o, m, l, do, mask,
                                                  causal, rate, key)
    dk_r, dv_r = fa.attention_bwd_dkv_reference(q, k, v, m, l, do, delta_r,
                                                mask, causal, rate, key)
    torch.cuda.synchronize()
    errs = {"o": _grad_err(o, o_r),
            "m": _stat_err(m, m_r), "l": _stat_err(l, l_r),
            "dq": _grad_err(dq, dq_r), "dk": _grad_err(dk, dk_r),
            "dv": _grad_err(dv, dv_r)}
    tols = {"o": ATTN_TOL[dtype], "m": STAT_TOL, "l": STAT_TOL,
            "dq": GRAD_TOL[dtype], "dk": GRAD_TOL[dtype],
            "dv": GRAD_TOL[dtype]}
    for name, err in errs.items():
        if not math.isfinite(err) or err > tols[name]:
            raise AssertionError(f"{name} ({dtype}, dropout {rate}): kernel "
                                 f"vs plain error {err} > {tols[name]}")
    return errs


def train_kernel_phase() -> dict:
    """Rows keyed (case, dropout rate)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, B, H, Lq, Lk, D, kind, causal, calls, path_rate in TRAIN_CASES:
        for rate in (0.0, DROPOUT):
            key = fa.dropout_key(2026, len(rows))
            errs = {}
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                q, k, v, mask = attention_inputs(B, H, Lq, Lk, D, kind,
                                                 dtype, gen)
                do = torch.randn(q.shape, generator=gen,
                                 device="cuda").to(dtype)
                errs[dtype] = check_train_kernels(q, k, v, do, mask, causal,
                                                  rate, key)
            row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
                   "mask": kind, "causal": causal, "dropout": rate,
                   "calls_per_step": calls if rate == path_rate else 0,
                   "max_err_bf16": errs[torch.bfloat16],
                   "max_err_f16": errs[torch.float16],
                   "max_err_f32": errs[torch.float32],
                   "tol": {"o_rel_16bit": ATTN_TOL[torch.bfloat16],
                           "o_rel_f32": ATTN_TOL[torch.float32],
                           "m_l_rel": STAT_TOL,
                           "grad_rel_16bit": GRAD_TOL[torch.bfloat16],
                           "grad_rel_f32": GRAD_TOL[torch.float32]},
                   **time_train_kernels(q, k, v, do, mask, causal, rate, key)}
            emit({"training_attention_case": row})
            rows[(name, rate)] = row
    return rows


def time_train_kernels(q, k, v, do, mask, causal, rate, key) -> dict:
    """At bf16, the main path's dtype: each kernel's device time (CUDA
    graph of 20 calls, CUDA events; and ``profiled_ms``, the sum of its
    kernel durations, as the yardstick is timed), its plain version's
    (graph), the bound, and scaled_dot_product_attention through autograd
    as the yardstick, by its kernels' device time (``profiled_ms``): its
    forward for the forward kernel, and its backward, which computes dq,
    dk and dv in one call, for both backward kernels (the same number in
    both: it is not to be added)."""
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, causal, rate,
                                              key)
    _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, m, l, do, mask,
                                              causal, rate, key)
    kernels = {
        "flash_attn_fwd_lse": lambda: fa.flash_attention_fwd_lse_cuda(
            q, k, v, mask, causal, rate, key),
        "flash_attn_bwd_dq": lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, v, o, m, l, do, mask, causal, rate, key),
        "flash_attn_bwd_dkv": lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, v, m, l, do, delta, mask, causal, rate, key)}
    plains = {
        "flash_attn_fwd_lse": lambda: fa.attention_forward_lse_reference(
            q, k, v, mask, causal, rate, key),
        "flash_attn_bwd_dq": lambda: fa.attention_bwd_dq_reference(
            q, k, v, o, m, l, do, mask, causal, rate, key),
        "flash_attn_bwd_dkv": lambda: fa.attention_bwd_dkv_reference(
            q, k, v, m, l, do, delta, mask, causal, rate, key)}
    Lq, Lk = q.shape[2], k.shape[2]
    sdpa_mask = mask
    if causal:
        tri = torch.ones(Lq, Lk, dtype=torch.bool, device="cuda").tril(Lk - Lq)
        sdpa_mask = tri if mask is None else mask & tri
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask,
                                              dropout_p=rate)
    lib_profiles = {"fwd": profiled(sdpa), "fwd_bwd": profiled(
        lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do))}
    lib_fwd, lib_fwd_bwd = (lib_profiles[k]["ms"] for k in ("fwd", "fwd_bwd"))
    library = {"flash_attn_fwd_lse": lib_fwd,
               "flash_attn_bwd_dq": lib_fwd_bwd - lib_fwd,
               "flash_attn_bwd_dkv": lib_fwd_bwd - lib_fwd}
    work = train_attention_work(q, k, mask, causal)
    times = {}
    for name in TRAIN_KERNELS:
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        times[name] = {
            "kernel_ms": device_ms(kernels[name]),
            "profiled_ms": profiled_ms(kernels[name]),
            "plain_ms": device_ms(plains[name]),
            "library_ms": library[name],
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    times["library_fwd_bwd_ms"] = lib_fwd_bwd
    times["library_profiles"] = {
        k: {"kernels_per_call": p["kernels_per_call"],
            "complete": p["complete"]} for k, p in lib_profiles.items()}
    return times


# -- phase 3, the generative step's training kernels -------------------------
def gen_train_cases(cfg: GenerativeVQAConfig, batch: int) -> list:
    """(name, B, H, Lq, Lk, mask kind, calls per step, the dropout rate
    of those calls) of the generative train step's attention: the ViT and
    text self-attention, the fusion over [49 patch tokens; 64 question
    tokens] under the query-AND-key mask, and per decoder layer one
    self-attention call under causal AND answer padding and one
    cross-attention call over the memory under its key mask."""
    vis = cfg.visual
    n_vis = (vis.image_size // vis.patch_size) ** 2
    Lq, La = cfg.text.max_length, cfg.max_answer_length
    return [
        ("gen_vit_self", batch, vis.num_heads, n_vis + 1, n_vis + 1, None,
         vis.num_layers, vis.dropout),
        ("gen_text_self", batch, cfg.text.num_heads, Lq, Lq, "text",
         cfg.text.num_layers, cfg.text.dropout),
        ("gen_fusion_self", batch, cfg.fusion_heads, n_vis + Lq, n_vis + Lq,
         "fusion", cfg.fusion_layers, cfg.dropout),
        ("gen_dec_self", batch, cfg.decoder_heads, La, La, "dec_self",
         cfg.decoder_layers, cfg.dropout),
        ("gen_dec_cross", batch, cfg.decoder_heads, La, n_vis + Lq, "cross",
         cfg.decoder_layers, cfg.dropout)]


def gen_train_masks(cfg: GenerativeVQAConfig, batch: int, gen) -> dict:
    """The masks the generative model builds for a batch of questions of
    3-60 tokens and answers of 1-6 tokens, by the model's own functions:
    (B, 1, Lq, Lk) bool, the cross mask (B, 1, 1, Lk), whose query axis
    the kernels read with stride 0."""
    vis = cfg.visual
    n_vis = (vis.image_size // vis.patch_size) ** 2
    Lq, La = cfg.text.max_length, cfg.max_answer_length
    dev = gen.device
    q_len = torch.randint(3, 61, (batch,), generator=gen, device=dev)
    a_len = torch.randint(1, 7, (batch,), generator=gen, device=dev) + 1
    q_mask = (torch.arange(Lq, device=dev)[None] < q_len[:, None]).int()
    d_mask = (torch.arange(La, device=dev)[None] < a_len[:, None]).int()
    memory = torch.cat([torch.ones(batch, n_vis, dtype=torch.int32,
                                   device=dev), q_mask], dim=1)
    return {"text": make_attention_mask(q_mask, q_mask),
            "fusion": make_attention_mask(memory, memory),
            "dec_self": make_causal_mask(d_mask)
            & make_attention_mask(d_mask, d_mask),
            "cross": make_attention_mask(None, memory)}


def gen_train_kernel_phase(cfg: GenerativeVQAConfig,
                           batch: int = GEN_TRAIN_BATCH) -> dict:
    """Rows keyed (case, dropout rate): each of the three training kernels
    at the generative step's shapes and masks, against its plain version
    in f32, f16 and bf16, with attention dropout at 0 and at GEN_DROPOUT
    (and at the path's rate where that is another), then timed in bf16
    as ``time_train_kernels`` times the classification cases."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for name, B, H, Lq, Lk, kind, calls, path_rate in gen_train_cases(cfg,
                                                                      batch):
        masks = gen_train_masks(cfg, B, gen)
        mask = None if kind is None else masks[kind]
        for rate in sorted({0.0, GEN_DROPOUT, path_rate}):
            key = fa.dropout_key(2027, len(rows))
            errs = {}
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                q, k, v, do = (torch.randn(B, H, L, 64, generator=gen,
                                           device="cuda").to(dtype)
                               for L in (Lq, Lk, Lk, Lq))
                errs[dtype] = check_train_kernels(q, k, v, do, mask, False,
                                                  rate, key)
            row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": 64,
                   "mask": kind,
                   "mask_shape": None if mask is None else list(mask.shape),
                   "keyless_rows": 0 if mask is None else int(
                       (~mask.expand(B, 1, Lq, Lk).any(-1)).sum()),
                   "dropout": rate,
                   "calls_per_step": calls if rate == path_rate else 0,
                   "max_err_bf16": errs[torch.bfloat16],
                   "max_err_f16": errs[torch.float16],
                   "max_err_f32": errs[torch.float32],
                   **time_train_kernels(q, k, v, do, mask, False, rate, key)}
            emit({"gen_training_attention_case": row})
            rows[(name, rate)] = row
    return rows


def step_totals(rows: dict) -> dict:
    """Per training kernel, the rows' numbers over one step's calls (each
    shape's number times its calls at the dropout those calls use): ms,
    profiler ms, plain ms, the bound from the summed bytes and flops, and
    SDPA's time (its backward under both backward kernels)."""
    main = [r for r in rows.values() if r["calls_per_step"]]
    err_keys = {"flash_attn_fwd_lse": ("o", "m", "l"),
                "flash_attn_bwd_dq": ("dq",),
                "flash_attn_bwd_dkv": ("dk", "dv")}
    out = {}
    for name in TRAIN_KERNELS:
        def total(key):
            return sum(r[name][key] * r["calls_per_step"] for r in main)
        t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
        t_flops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
        out[name] = {
            "calls_per_step": sum(r["calls_per_step"] for r in main),
            "max_abs_err": max(r["max_err_bf16"][k] for r in main
                               for k in err_keys[name]),
            "ms": total("kernel_ms"), "profiled_ms": total("profiled_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": total("library_ms"),
            "library_profiles_complete": all(
                p["complete"] for r in main
                for p in r["library_profiles"].values()),
            "by_case_ms": {r["case"]: r[name]["kernel_ms"] * r["calls_per_step"]
                           for r in main}}
    return out


# -- phase 4: serving --------------------------------------------------------
WORDS = ("cái gì màu có bao nhiêu con mèo chó người đàn ông phụ nữ đang làm "
         "ở trên dưới bàn ghế xe đạp máy bay nhà cửa sổ bên trái phải "
         "trong ảnh này là không vậy").split()


def make_requests(n: int, seed: int, image_hw=(256, 320)):
    """Seeded uint8 images and questions of 3 to 60 words."""
    rs = np.random.RandomState(seed)
    images = [rs.randint(0, 256, (*image_hw, 3), dtype=np.uint8)
              for _ in range(n)]
    lengths = rs.randint(3, 61, n)
    questions = [" ".join(rs.choice(WORDS, size=L)) for L in lengths]
    return images, questions


def compare_logits(card: np.ndarray, cpu: np.ndarray) -> dict:
    """Card vs CPU logits of the same weights and inputs. Both compute the
    trunk in bf16 but round and sum in different places over ~40 layers,
    so the tolerance scales with the logits: max |diff| <= 5% of
    max |logit|. Top-1 must agree on every request whose CPU margin
    between its top two answers exceeds twice that tolerance."""
    diff = float(np.abs(card - cpu).max())
    tol = 0.05 * float(np.abs(cpu).max())
    top_card, top_cpu = card.argmax(-1), cpu.argmax(-1)
    srt = np.sort(cpu, axis=-1)
    margin = srt[:, -1] - srt[:, -2]
    decided = margin > 2 * tol
    out = {"max_abs_logit_diff": diff, "tolerance": tol,
           "top1_agree": int((top_card == top_cpu).sum()),
           "requests": int(len(cpu)),
           "decided": int(decided.sum()),
           "decided_agree": int((top_card == top_cpu)[decided].sum())}
    if not math.isfinite(diff) or diff > tol \
            or out["decided_agree"] != out["decided"]:
        raise AssertionError(f"card vs CPU logits disagree: {out}")
    return out


def serving_phase(cfg: VQAModelConfig, device: str, batches: int = 10,
                  batch: int = 8, seed: int = 0) -> dict:
    """Answer ``batches`` batches of ``batch`` requests through
    VQAPredictor on ``device``; count kernel launches; check one batch
    against the same weights on the CPU."""
    image_size = cfg.visual.image_size
    tok = WhitespaceTokenizer(max_length=cfg.text.max_length)
    tok.build_vocab(WORDS)
    id2answer = {i: f"answer_{i}" for i in range(cfg.num_answers)}
    t0 = time.perf_counter()
    cpu_model = create_vqa_model(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
    model = copy.deepcopy(cpu_model)
    predictor = VQAPredictor(model, tok, id2answer, image_size=image_size,
                             top_k=5, batch_pad=batch, device=device)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    warm_images, warm_questions = make_requests(batch, seed + 100)
    predictor.predict_batch(warm_images, warm_questions)     # warm-up

    requests = [make_requests(batch, seed + 1 + i) for i in range(batches)]
    fa.reset_launch_counts()
    latencies, forward_ms, answers = [], [], []
    for images, questions in requests:
        t = time.perf_counter()
        results = predictor.predict_batch(images, questions)
        latencies.append((time.perf_counter() - t) * 1e3)
        forward_ms.append(results[0].inference_ms * len(results))
        answers.append([r.answer for r in results])
        for r in results:
            if not (math.isfinite(r.confidence) and 0 < r.confidence <= 1
                    and len(r.top_answers) == 5):
                raise AssertionError(f"bad prediction {r}")
    launches = dict(fa.launch_counts)
    want = ATTN_CALLS_PER_FORWARD * batches if device == "cuda" else 0
    if launches["flash_attn_fwd"] != want:
        raise AssertionError(f"attention launches {launches} != {want} "
                             f"({ATTN_CALLS_PER_FORWARD} x {batches})")

    images, questions = requests[0]
    px = np.stack([predictor.transform(im) for im in images])
    enc = tok.encode_batch(questions, cfg.text.max_length)
    args = (torch.from_numpy(px), torch.from_numpy(enc["input_ids"]),
            torch.from_numpy(enc["attention_mask"]))
    dev_args = tuple(a.to(predictor.device) for a in args)
    with torch.inference_mode():
        card_logits = model(*dev_args)["logits"].float().cpu().numpy()
        t = time.perf_counter()
        cpu_logits = cpu_model(*args)["logits"].float().numpy()
        cpu_s = time.perf_counter() - t
    if card_logits.shape != (batch, cfg.num_answers) \
            or not np.isfinite(card_logits).all():
        raise AssertionError(f"bad logits {card_logits.shape}")
    check = compare_logits(card_logits, cpu_logits)
    profile = profile_phase(model, dev_args) if device == "cuda" else None
    mean_latency = float(np.mean(latencies))
    return {"params": n_params, "setup_s": setup_s, "batches": batches,
            "batch": batch,
            "question_lengths": [int(m.sum()) for m in enc["attention_mask"]],
            "batch_latency_ms": latencies, "forward_ms": forward_ms,
            "mean_batch_latency_ms": mean_latency,
            "median_batch_latency_ms": float(np.median(latencies)),
            "answers_per_s": batch * 1e3 / mean_latency,
            "launches": launches, "launches_per_forward":
                launches["flash_attn_fwd"] / batches,
            "first_answers": answers[0], "cpu_check": check,
            "profile": profile,
            "cpu_forward_s": cpu_s}


# -- phase 4, end: where the serving forward's time goes ---------------------
def profile_phase(model, args, forwards: int = 3) -> dict:
    """One batch's forward three ways: eager (host clock to a
    synchronize), replayed as one CUDA graph (the device's own time with
    the host's dispatch removed), and under torch.profiler (the kernels'
    device time, so the device's idle share of the eager forward)."""
    from torch.profiler import ProfilerActivity, profile

    def forward():
        return model(*args)["logits"]

    with torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(forwards):
            forward()
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) * 1e3 / forwards

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            forward()
        graph.replay()
        torch.cuda.synchronize()
        graphed = _events_ms(graph.replay, 10)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                forward()
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(t for _, t in kernels.values()) / 1e3 / forwards
    attn = sum(t for n, (_, t) in kernels.items()
               if KERNEL_NAMES["flash_attn_fwd"] in n) / 1e3 / forwards
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "eager_forward_ms": eager, "graph_forward_ms": graphed,
        "device_busy_ms": busy if kernels else None,
        "device_idle_share": 1 - busy / eager if kernels else None,
        "attention_device_ms": attn if kernels else None,
        "kernels_per_forward": sum(c for c, _ in kernels.values())
        / forwards,
        "top_kernels": [{"name": n[:90], "calls": c / forwards,
                         "ms": t / 1e3 / forwards} for n, (c, t) in top]}


# -- phase 6: training ------------------------------------------------------
def training_phase(cfg: VQAModelConfig, device: str = "cuda",
                   steps: int = 10, warmup: int = 3,
                   batch: int = TRAIN_BATCH, seed: int = 0) -> dict:
    """``steps`` timed train steps on ``device`` after ``warmup``; every
    step ends in a synchronize, so step_ms is what a training loop that
    reads its loss pays. (On the CPU, a rehearsal at a tiny size: no
    events, launches or profile.)"""
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = create_vqa_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(seed))
    state = TrainState.create(model, bench_optimizer(model), seed=seed)
    train_step = make_train_step(classification_loss_fn())
    data = synthetic_batch(cfg, batch, device)
    sync()
    setup_s = time.perf_counter() - t0
    for _ in range(warmup):
        train_step(state, data)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    host_ms, event_ms, metrics = bench.time_train_steps(state, train_step,
                                                        data, steps)
    launches = dict(fa.launch_counts)
    calls = ATTN_CALLS_PER_STEP * steps if on_card else 0
    want = {name: calls for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = 0
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss {losses} or grad_norm {norms}")
    step_ms = float(np.median(host_ms))
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch": batch, "steps": steps, "warmup_steps": warmup,
            "setup_s": setup_s, "step_ms": host_ms, "step_event_ms": event_ms,
            "median_step_ms": step_ms,
            "qa_pairs_per_s": batch * 1e3 / step_ms,
            "loss": losses, "grad_norm": norms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None,
            "launches": launches,
            "launches_per_step": {n: launches[n] / steps
                                  for n in TRAIN_KERNELS},
            "profile": train_profile(state, train_step, data, step_ms)
            if on_card else None}


def train_profile(state, train_step, data, step_ms: float) -> dict:
    """One train step under torch.profiler: the kernels' device time, so
    the device's idle share of the eager step, each attention kernel's
    device ms, and the f32 GEMMs' (cuBLAS' f32 kernels, the generative
    step's tied logits forward and backward)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(state, data)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(t for _, t in kernels.values()) / 1e3
    attention = {name: sum(t for n, (_, t) in kernels.items()
                           if KERNEL_NAMES[name] in n) / 1e3
                 for name in ("flash_attn_fwd",) + TRAIN_KERNELS}
    f32_gemms = [(c, t) for n, (c, t) in kernels.items()
                 if "f32f32" in n or "sgemm" in n]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return {"device_busy_ms": busy if kernels else None,
            "device_idle_share": 1 - busy / step_ms if kernels else None,
            "attention_device_ms": attention,
            "f32_gemm_device_ms": sum(t for _, t in f32_gemms) / 1e3,
            "f32_gemm_launches": sum(c for c, _ in f32_gemms),
            "kernels_per_step": sum(c for c, _ in kernels.values()),
            "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3}
                            for n, (c, t) in top]}


def train_check(cfg: VQAModelConfig, device: str = "cuda", steps: int = 2,
                seed: int = 0) -> dict:
    """The same weights, dropout 0, on the card and on the CPU (the plain
    versions): ``steps`` train steps on a batch of 4 with questions of
    64, 40, 17 and 5 tokens, so padded query rows are fully masked and
    their backward runs. bench.py's optimizer with a one-step warmup, so
    the second step moves the weights at lr 1e-4.

    Tolerances: the trunk is bf16 on both and rounds at other points, so
    the loss and grad_norm of each step agree to 2% and 5%. An Adam step
    moves each weight by about lr whatever the gradient's size, and a
    gradient at bf16 noise may flip sign, so elementwise the updates
    agree only to 3 lr; over all weights the two updates must point the
    same way (cosine >= 0.9)."""
    cfg0 = cfg.replace(text=cfg.text.replace(dropout=0.0),
                       fusion=cfg.fusion.replace(dropout=0.0),
                       head=cfg.head.replace(dropout=0.0))
    S, L = cfg.visual.image_size, cfg.text.max_length
    rs = np.random.RandomState(seed + 7)
    lengths = np.array([L, 40, 17, 5])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    data = {"pixel_values": rs.rand(4, S, S, 3).astype(np.float32),
            "input_ids": rs.randint(4, cfg.text.vocab_size - 1, (4, L)) * mask,
            "attention_mask": mask,
            "labels": rs.randint(0, cfg.num_answers, (4,))}

    def build(dev):
        model = create_vqa_model(cfg0, device=dev,
                                 generator=torch.Generator().manual_seed(seed))
        model.moe.dropout = 0.0
        return TrainState.create(model, bench_optimizer(model, 1), seed=seed)
    out = card_vs_cpu_steps(build, classification_loss_fn(), data, device,
                            steps, ATTN_CALLS_PER_STEP)
    return {"batch": 4, "question_lengths": lengths.tolist(), **out}


def card_vs_cpu_steps(build, loss_fn, data: dict, device: str, steps: int,
                      calls_per_step: int) -> dict:
    """``steps`` train steps of the same weights (``build(device)`` gives
    a TrainState) on the CPU and on ``device`` over ``data`` (numpy
    arrays), held to ``train_check``'s tolerances; every attention call
    on the card goes through the training kernels, none on the CPU."""
    runs, before = {}, None
    for dev in ("cpu", device):
        t0 = time.perf_counter()
        state = build(dev)
        model = state.model
        if before is None:
            before = {n: p.detach().clone() for n, p in
                      model.named_parameters()}
        train_step = make_train_step(loss_fn)
        batch = batch_to_device(data, torch.device(dev))
        fa.reset_launch_counts()
        metrics = [train_step(state, batch)[1] for _ in range(steps)]
        runs[dev] = {"loss": [float(m["loss"]) for m in metrics],
                     "grad_norm": [float(m["grad_norm"]) for m in metrics],
                     "launches": dict(fa.launch_counts),
                     "seconds": time.perf_counter() - t0,
                     "update": {n: p.detach().cpu() - before[n]
                                for n, p in model.named_parameters()}}
    cpu, card = runs["cpu"], runs[device]
    lr_sum = sum(state.schedule(i) for i in range(steps))
    dot = sum(float((card["update"][n] * u).sum())
              for n, u in cpu["update"].items())
    n_cpu = math.sqrt(sum(float(u.square().sum())
                          for u in cpu["update"].values()))
    n_card = math.sqrt(sum(float(u.square().sum())
                           for u in card["update"].values()))
    max_diff = max(float((card["update"][n] - u).abs().max())
                   for n, u in cpu["update"].items())
    out = {"steps": steps,
           "loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "grad_norm_cpu": cpu["grad_norm"],
           "grad_norm_card": card["grad_norm"],
           "update_cosine": dot / max(n_cpu * n_card, 1e-30),
           "update_norm_cpu": n_cpu, "update_norm_card": n_card,
           "max_abs_param_diff": max_diff, "lr_sum": lr_sum,
           "card_launches": card["launches"],
           "cpu_seconds": cpu["seconds"], "card_seconds": card["seconds"],
           "tolerance": {"loss_rel": 2e-2, "grad_norm_rel": 5e-2,
                         "param_abs": 3 * lr_sum, "update_cosine_min": 0.9}}
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    per_step = calls_per_step * steps if device == "cuda" else 0
    if (rel(card["loss"], cpu["loss"]) > 2e-2
            or rel(card["grad_norm"], cpu["grad_norm"]) > 5e-2
            or max_diff > 3 * lr_sum or out["update_cosine"] < 0.9
            or any(card["launches"][n] != per_step for n in TRAIN_KERNELS)
            or any(cpu["launches"].values())):
        raise AssertionError(f"card vs CPU training disagree: {out}")
    return out


# -- phase 5: generative serving ---------------------------------------------
GEN_BATCHES = (16, 64)
GEN_STRATEGIES = ("greedy", "beam")
# card vs card and card vs CPU, as compare_logits: teacher-forced tokens
# must equal the cached decode's wherever the teacher-forced top-1/top-2
# margin exceeds twice CACHE_TOL x max |logit|. Both run the same bf16
# trunk on the card; they differ in the shapes of their products (one
# query a step against 32), whose sums cuBLAS may order differently, so a
# few bf16 ulps of the logits' scale (2**-8 relative each).
CACHE_TOL = 0.02


def attention_calls_per_generate(cfg: GenerativeVQAConfig,
                                 new_tokens: int) -> int:
    """ViT and text self-attention, fusion, then per step one self and
    one cross call per decoder layer: 12 + 12 + 3 + 32 x 6 x 2 = 411 at
    bench_serving's config."""
    return (cfg.visual.num_layers + cfg.text.num_layers + cfg.fusion_layers
            + new_tokens * cfg.decoder_layers * 2)


def _first_eos_mask(seqs: torch.Tensor, eos: int) -> torch.Tensor:
    """True up to and including each row's first EOS: the positions whose
    token the decode chose (later ones hold pad)."""
    after = torch.cumsum((seqs == eos).long(), dim=1) - (seqs == eos).long()
    return after == 0


def cache_consistency(model, args, seqs, decode_cfg) -> dict:
    """The card's greedy sequences against its own teacher-forced argmax
    on the same tokens (BOS, then each sequence but its last token)."""
    bos = torch.full_like(seqs[:, :1], decode_cfg.bos_token_id)
    with torch.inference_mode():
        logits = model(*args, torch.cat([bos, seqs[:, :-1]], dim=1))[
            "logits"].float()
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    tol = CACHE_TOL * float(logits.abs().max())
    chosen = _first_eos_mask(seqs, decode_cfg.eos_token_id)
    decided = chosen & (margin > 2 * tol)
    agree = logits.argmax(-1) == seqs
    out = {"positions": int(chosen.sum()), "decided": int(decided.sum()),
           "decided_agree": int((agree & decided).sum()),
           "agree": int((agree & chosen).sum()), "tolerance": tol}
    if out["decided"] == 0 or out["decided_agree"] != out["decided"]:
        raise AssertionError(f"cached decode vs teacher forcing: {out}")
    return out


def generate_profile(generate, args, reps: int = 3) -> dict:
    """One generate eager (host clock to a synchronize, median of
    ``reps``) and under torch.profiler: device busy time, idle share, the
    forward attention kernel's device time, kernels per generate."""
    from torch.profiler import ProfilerActivity, profile
    eager = []
    for _ in range(reps):
        t0 = time.perf_counter()
        generate(*args)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generate(*args)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(t for _, t in kernels.values()) / 1e3
    eager_median = float(np.median(eager))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {"eager_generate_ms": eager_median,
            "device_busy_ms": busy if kernels else None,
            "device_idle_share": 1 - busy / eager_median if kernels else None,
            "attention_device_ms": sum(
                t for n, (_, t) in kernels.items()
                if KERNEL_NAMES["flash_attn_fwd"] in n) / 1e3,
            "attention_launches": sum(
                c for n, (c, _) in kernels.items()
                if KERNEL_NAMES["flash_attn_fwd"] in n),
            "kernels_per_generate": sum(c for c, _ in kernels.values()),
            "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3}
                            for n, (c, t) in top]}


def generative_phase(cfg: GenerativeVQAConfig, device: str = "cuda",
                     batches=GEN_BATCHES, new_tokens: int = 32,
                     windows: int = 3, iters: int = 5, lat_calls: int = 5,
                     seed: int = 0) -> dict:
    """bench_serving's model with seeded weights on ``device``: greedy and
    beam at each batch through ``build_generate_fn``, timed with the
    port's bench_serving functions (every forward-kernel launch counted,
    none of the training kernels); each call's sequences (B, new_tokens)
    and finite scores; the greedy sequences against teacher forcing on the
    card; card against CPU at batch 2; one greedy and one beam generate
    profiled. (On the CPU, a rehearsal at a tiny size.)"""
    on_card = device == "cuda"
    t0 = time.perf_counter()
    cpu_model = create_generative_vqa_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    model = copy.deepcopy(cpu_model).to(device)
    px, q = (torch.from_numpy(a).to(device) for a in
             bench_serving.synthetic_requests(cfg, max(batches)))
    setup_s = time.perf_counter() - t0
    per_generate = attention_calls_per_generate(cfg, new_tokens)
    gens = {s: build_generate_fn(model, bench_serving.decode_config(
        s, new_tokens)) for s in GEN_STRATEGIES}

    results, outputs, n_generates = {}, {}, 0
    fa.reset_launch_counts()
    for B in batches:
        for strategy in GEN_STRATEGIES:
            key = f"{strategy}_b{B}"
            results[key], (seqs, scores) = bench_serving.bench_one(
                gens[strategy], (px[:B], q[:B]), B, windows, iters,
                lat_calls)
            n_generates += 1 + windows * iters + lat_calls
            if seqs.shape != (B, new_tokens) \
                    or not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"{key}: sequences {tuple(seqs.shape)}"
                                     f", scores {scores}")
            outputs[key] = seqs
            print(f"[generative] {key}: {results[key]}", flush=True)
    launches = dict(fa.launch_counts)
    want = {name: 0 for name in launches}
    want["flash_attn_fwd"] = per_generate * n_generates if on_card else 0
    if launches != want:
        raise AssertionError(f"generative launches {launches} != {want} "
                             f"({per_generate} x {n_generates} generates)")

    B0 = batches[0]
    decode_cfg = bench_serving.decode_config("greedy", new_tokens)
    consistency = cache_consistency(model, (px[:B0], q[:B0]),
                                    outputs[f"greedy_b{B0}"], decode_cfg)
    # card against CPU at batch 2, teacher-forced on the card's greedy
    # sequences: compare_logits' rule (5% of max |logit|)
    seqs2, _ = gens["greedy"](px[:2], q[:2])
    bos = torch.full_like(seqs2[:, :1], decode_cfg.bos_token_id)
    dec_in = torch.cat([bos, seqs2[:, :-1]], dim=1)
    with torch.inference_mode():
        card = model(px[:2], q[:2], dec_in)["logits"].float().cpu()
        t = time.perf_counter()
        cpu = cpu_model(px[:2].cpu(), q[:2].cpu(), dec_in.cpu())[
            "logits"].float()
        cpu_s = time.perf_counter() - t
    V = cpu.shape[-1]
    cpu_check = compare_logits(card.reshape(-1, V).numpy(),
                               cpu.reshape(-1, V).numpy())
    cpu_check["cpu_forward_s"] = cpu_s
    profiles = {key: generate_profile(gens[key.split("_b")[0]],
                                      (px[:B0], q[:B0]))
                for key in (f"greedy_b{B0}", f"beam_b{B0}")} \
        if on_card else None
    return {"params": sum(p.numel() for p in model.parameters()),
            "setup_s": setup_s, "new_tokens": new_tokens,
            "windows": windows, "window_iters": iters,
            "latency_calls": lat_calls, "results": results,
            "generates": n_generates, "launches": launches,
            "launches_per_generate": launches["flash_attn_fwd"]
            / n_generates,
            "attention_calls_per_generate": per_generate,
            "first_sequences": {k: v[:2].tolist() for k, v in
                                outputs.items()},
            "cache_consistency": consistency, "cpu_check": cpu_check,
            "profile": profiles}


# -- phase 7: generative training --------------------------------------------
def gen_training_config(tok: WhitespaceTokenizer) -> GenerativeVQAConfig:
    """bench_convergence_gen.py:83-96's flagship mode (bench_serving's
    model, dropout 0.05, label smoothing 0), with the tokenizer's special
    ids."""
    return bench_serving.serving_config().replace(
        dropout=GEN_DROPOUT, label_smoothing=0.0,
        bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
        pad_token_id=tok.pad_token_id)


def gen_optimizer(model, total_steps: int = 1000):
    """bench_convergence_gen.py:120-125: AdamW at lr 1e-3, weight decay
    0.01 under the no-decay mask, global-norm clipping at 1.0,
    warmup_cosine with a warmup ratio of 0.05 (of a 1,000-step run)."""
    return create_optimizer(
        OptimizerConfig(learning_rate=1e-3, weight_decay=0.01), model,
        SchedulerConfig(name="warmup_cosine", warmup_ratio=0.05,
                        total_steps=total_steps))


def gen_tokenizer() -> WhitespaceTokenizer:
    tok = WhitespaceTokenizer(max_length=64)
    tok.build_vocab(WORDS)
    return tok


def gen_train_batch(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                    n: int, seed: int) -> dict:
    """``n`` seeded requests (questions of 3-60 words) with answers of 1-6
    words, through the port's GenerativeVQADataset (eval pixels,
    teacher-forcing targets) and generative_collate: numpy arrays."""
    images, questions = make_requests(n, seed)
    rs = np.random.RandomState(seed + 1000)
    answers = [" ".join(rs.choice(WORDS, size=L))
               for L in rs.randint(1, 7, n)]
    ds = GenerativeVQADataset(
        [OneSample(im, q, [a]) for im, q, a in zip(images, questions,
                                                    answers)],
        tok, ImageAugmentation(cfg.visual.image_size),
        max_question_length=cfg.text.max_length,
        max_answer_length=cfg.max_answer_length)
    return generative_collate([ds[i] for i in range(n)])


def gen_calls_per_step(cfg: GenerativeVQAConfig) -> int:
    """12 ViT + 12 text + 3 fusion + 6 decoder self + 6 cross = 39."""
    return (cfg.visual.num_layers + cfg.text.num_layers + cfg.fusion_layers
            + 2 * cfg.decoder_layers)


def gen_training_phase(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                       device: str = "cuda", steps: int = 10,
                       warmup: int = 3, batch: int = GEN_TRAIN_BATCH,
                       seed: int = 0) -> dict:
    """The generative train step at ``cfg`` on ``device``: ``steps`` timed
    steps after ``warmup`` on one batch (step ms by host clock and CUDA
    events, answer tokens/s and QA-pairs/s, peak memory, launches per
    step: every attention call through the three training kernels, none
    through the forward), then one step under torch.profiler. (On the
    CPU, a rehearsal at a tiny size.)"""
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = create_generative_vqa_model(
        cfg, device=device, generator=torch.Generator().manual_seed(seed))
    state = TrainState.create(model, gen_optimizer(model), seed=seed)
    train_step = make_train_step(generative_loss_fn(label_smoothing=0.0))
    host = gen_train_batch(cfg, tok, batch, seed)
    data = batch_to_device(host, torch.device(device))
    n_tokens = int((host["labels"] != IGNORE_INDEX).sum())
    sync()
    setup_s = time.perf_counter() - t0
    for _ in range(warmup):
        train_step(state, data)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    host_ms, event_ms, metrics = bench.time_train_steps(state, train_step,
                                                        data, steps)
    launches = dict(fa.launch_counts)
    per_step = gen_calls_per_step(cfg)
    want = {name: per_step * steps if on_card else 0
            for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = 0
    if launches != want:
        raise AssertionError(f"generative training launches {launches} != "
                             f"{want}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms) \
            or int(metrics[0]["n_tokens"]) != n_tokens:
        raise AssertionError(f"loss {losses}, grad_norm {norms}, n_tokens "
                             f"{int(metrics[0]['n_tokens'])} != {n_tokens}")
    step_ms = float(np.median(host_ms))
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch": batch, "steps": steps, "warmup_steps": warmup,
            "setup_s": setup_s,
            "question_tokens": host["question_mask"].sum(1).tolist(),
            "answer_positions": host["decoder_mask"].sum(1).tolist(),
            "answer_tokens_per_batch": n_tokens,
            "step_ms": host_ms, "step_event_ms": event_ms,
            "median_step_ms": step_ms,
            "median_step_event_ms": float(np.median(event_ms))
            if event_ms else None,
            "answer_tokens_per_s": n_tokens * 1e3 / step_ms,
            "qa_pairs_per_s": batch * 1e3 / step_ms,
            "loss": losses, "grad_norm": norms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None,
            "launches": launches,
            "launches_per_step": {n: launches[n] / steps
                                  for n in TRAIN_KERNELS},
            "profile": train_profile(state, train_step, data, step_ms)
            if on_card else None}


def gen_train_check(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                    device: str = "cuda", steps: int = 2,
                    seed: int = 0) -> dict:
    """The generative step card against CPU: the same weights at dropout
    0 (the text encoder's too), two steps on a batch of 4 (questions and
    answers of mixed lengths, so padded query rows and the decoder's
    keyless rows run their backward), with ``gen_optimizer``'s AdamW at a
    one-step warmup, so the second step moves the weights at lr 1e-3.
    ``train_check``'s tolerances, for the same reasons (a bf16 trunk on
    both sides, rounded at other points)."""
    cfg0 = cfg.replace(dropout=0.0, text=cfg.text.replace(dropout=0.0))
    data = gen_train_batch(cfg0, tok, 4, seed + 7)

    def build(dev):
        model = create_generative_vqa_model(
            cfg0, device=dev, generator=torch.Generator().manual_seed(seed))
        return TrainState.create(model, gen_optimizer(model, 20), seed=seed)
    out = card_vs_cpu_steps(build, generative_loss_fn(label_smoothing=0.0),
                            data, device, steps, gen_calls_per_step(cfg))
    return {"batch": 4,
            "question_tokens": data["question_mask"].sum(1).tolist(),
            "answer_positions": data["decoder_mask"].sum(1).tolist(), **out}


def decode_steps_taken(seqs: torch.Tensor, eos: int) -> int:
    """Steps an early-exit greedy decode took to give ``seqs`` (B, L):
    up to the one at which its last row emitted EOS, else all L."""
    ended = seqs == eos
    if not bool(ended.any(1).all()):
        return seqs.shape[1]
    return int(ended.int().argmax(1).max()) + 1


def pipeline_phase(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                   device: str = "cuda", steps: int = 3,
                   batch: int = GEN_TRAIN_BATCH,
                   val_batch: int = GEN_VAL_BATCH, seed: int = 0) -> dict:
    """One short ``GenerativeTrainingPipeline.run`` on ``device``: one
    epoch of ``steps`` steps under its default onecycle schedule, a
    one-batch greedy validation (every attention call of the generate
    through the forward kernel), a checkpoint in a temporary directory
    whose restore_best gives back the model's parameters bit for bit."""
    model = create_generative_vqa_model(
        cfg, device=device, generator=torch.Generator().manual_seed(seed))
    train = [gen_train_batch(cfg, tok, batch, seed + 10 + i)
             for i in range(steps)]
    val = [gen_train_batch(cfg, tok, val_batch, seed + 20)]
    with tempfile.TemporaryDirectory() as directory:
        pcfg = GenerativeTrainingConfig(
            num_epochs=1, label_smoothing=0.0, checkpoint_dir=directory,
            optimizer=OptimizerConfig(learning_rate=1e-3, weight_decay=0.01),
            log_every=1, max_eval_batches=1)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = GenerativeTrainingPipeline(pcfg).run(model, train, val, tok)
        seconds = time.perf_counter() - t0
        launches = dict(fa.launch_counts)
        ckpt = CheckpointManager(CheckpointConfig(directory=directory,
                                                  best_metric="bleu"))
        saved, meta = ckpt.restore_best()
        steps_saved = ckpt.all_steps()
    on_card = device == "cuda"
    same = all(torch.equal(saved["params"][n], p.detach().cpu())
               for n, p in model.named_parameters())
    # the validation generate runs the encoders' calls, then 2 x
    # decoder_layers calls a step until every row has emitted EOS (the
    # pipeline's DecodeConfig keeps early_exit); the same greedy generate
    # on the saved (so the validated) parameters says how many steps that
    # took, from its sequences
    vb = batch_to_device(val[0], torch.device(device))
    seqs, _ = build_generate_fn(model, DecodeConfig(
        max_length=cfg.max_answer_length, bos_token_id=cfg.bos_token_id,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id))(
        vb["pixel_values"], vb["question_ids"], vb["question_mask"])
    decode_steps = decode_steps_taken(seqs.cpu(), cfg.eos_token_id)
    want = {name: gen_calls_per_step(cfg) * steps if on_card else 0
            for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = (attention_calls_per_generate(cfg, 0)
                              + 2 * cfg.decoder_layers * decode_steps
                              if on_card else 0)
    history = out.history
    if launches != want or len(history) != 1 \
            or not all(math.isfinite(v) for v in history[0].values()) \
            or steps_saved != [steps] or not same:
        raise AssertionError(
            f"pipeline run: launches {launches} (want {want}), history "
            f"{history}, checkpoints {steps_saved}, restore_best equal "
            f"{same}")
    return {"steps": steps, "batch": batch, "val_batch": val_batch,
            "seconds": seconds, "history": history, "launches": launches,
            "validation_decode_steps": decode_steps,
            "checkpoint_steps": steps_saved, "checkpoint_epoch":
                meta["epoch"], "restore_best_bit_equal": same}


def kernels_line(rows: dict, launches: int, generative: dict,
                 train_rows: dict, train_launches: dict,
                 ptxas: dict, gen_rows: dict, gen_training: dict) -> dict:
    """One entry per kernel. The forward's numbers are for one flagship
    forward at batch 8 (its 36 calls of the five serving shapes, each
    shape's time times its calls), and, under ``generate``, for one beam
    generate at batch 16 (its 411 calls); the training kernels' for one
    flagship train step at batch 128 (36 calls each, at the dropout each
    call uses), and, under ``generative_step``, for one generative train
    step at batch 32 (39 calls each). ``ms`` is CUDA-graph replay,
    ``profiled_ms`` the profiler's sum of kernel durations (as
    ``library_ms`` is timed); registers and spills are ptxas' for the
    template the main path runs."""
    entries = [forward_entry(rows, launches, ptxas["flash_attn_fwd"])]
    entries[0]["generate"] = generate_entry(rows, generative)
    totals = step_totals(train_rows)
    gen_totals = step_totals(gen_rows)
    replaces = {
        "flash_attn_fwd_lse": ("flash_attn_fwd.cu", ":142 (_flash_kernel_lse, "
                               "pallas_call at :206)"),
        "flash_attn_bwd_dq": ("flash_attn_bwd_dq.cu", ":285 "
                              "(_flash_bwd_dq_kernel, pallas_call at :377)"),
        "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv.cu", ":230 "
                               "(_flash_bwd_dkv_kernel, pallas_call at "
                               ":351)")}
    for name in TRAIN_KERNELS:
        source, where = replaces[name]
        step = {k: v for k, v in totals[name].items()
                if k not in ("calls_per_step", "by_case_ms")}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"vivqa_tpu_torch/csrc/{source}",
            "replaces": f"vivqa_tpu/ops/flash_attention.py{where}",
            "launches": train_launches[name], **step, **ptxas[name],
            "per": f"one flagship train step at batch {TRAIN_BATCH} "
                   f"({ATTN_CALLS_PER_STEP} calls), bf16; max_abs_err is "
                   f"relative to each tensor's largest value for dq/dk/dv "
                   f"and m/l",
            "generative_step": {
                **gen_totals[name],
                "launches": gen_training["launches"][name],
                "launches_per_step":
                    gen_training["launches_per_step"][name],
                "per": f"one generative train step at batch "
                       f"{gen_training['batch']}, bf16"}})
    return {"kernels": entries}


def _path_totals(rows: dict, calls_key: str) -> dict:
    """The rows' times, bound and largest bf16 error over one pass of a
    path (each shape's number times its calls)."""
    main = [r for r in rows.values() if r[calls_key]]

    def total(key):
        return sum(r[key] * r[calls_key] for r in main)
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_flops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    return {"max_abs_err": max(r["max_abs_err_bf16"] for r in main),
            "ms": total("kernel_ms"),
            "profiled_ms": total("kernel_profiled_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": total("library_ms"),
            "ms_by_tile_rows": {t: sum(r["kernel_ms_by_tile_rows"][t]
                                       * r[calls_key] for r in main)
                                for t in fa.TILE_ROWS}}


def generate_entry(rows: dict, generative: dict) -> dict:
    """The forward kernel per generate: the launches counted per generate
    in the generative phase, and the kernel-phase times of the calls of
    one beam generate at batch 16, with the profiler's attention time of
    that generate."""
    profile = (generative["profile"] or {}).get(GEN_HEAD) or {}
    return {"launches_per_generate": generative["launches_per_generate"],
            "launches": generative["launches"]["flash_attn_fwd"],
            "generates": generative["generates"],
            **_path_totals(rows, "calls_per_generate"),
            "profiled_in_generate_ms": profile.get("attention_device_ms"),
            "per": f"one {GEN_HEAD.replace('_b', ' generate at batch ')} "
                   f"at bench_serving's config "
                   f"({generative['attention_calls_per_generate']} calls),"
                   f" bf16"}


def forward_entry(rows: dict, launches: int, ptxas: dict) -> dict:
    totals = _path_totals(rows, "calls_per_forward")
    return {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "vivqa_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "vivqa_tpu/ops/flash_attention.py:61 (_flash_kernel, "
                    "pallas_call at :127)",
        "launches": launches, **totals, **ptxas,
        "tile_rows": {"Lq > 16": fa.SERVING_TILE_ROWS,
                      "Lq <= 16": fa.DECODE_TILE_ROWS},
        "per": f"one flagship forward at batch 8 "
               f"({ATTN_CALLS_PER_FORWARD} calls), bf16"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    resolve_device("cuda")          # also turns TF32 off for f32 products
    torch.set_num_threads(8)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {card}", flush=True)

    ptxas = build_phase()
    rows = kernel_phase()
    tiles = tile_rows_line(rows)
    emit(tiles)
    print("[kernels] serving forward per flagship forward (bf16): "
          + ", ".join(f"{t} rows {ms:.4f} ms" for t, ms in
                      tiles["serving_tile_rows"]["kernel_ms_by_tile_rows"]
                      .items())
          + f"; the serving path uses {fa.SERVING_TILE_ROWS}; per beam "
          f"generate at batch 16: " + ", ".join(
              f"{t} rows {ms:.4f} ms" for t, ms in
              tiles["serving_tile_rows"]["generate"]["kernel_ms_by_tile_rows"]
              .items())
          + f"; the decoder's single-query calls use {fa.DECODE_TILE_ROWS}"
          f" (decode calls of the four bench_serving configurations "
          f"together: " + ", ".join(
              f"{t} rows {ms:.4f} ms" for t, ms in
              tiles["serving_tile_rows"]["decode_rule"]
              ["ms_all_configs_by_tile_rows"].items()) + ")",
          flush=True)
    train_rows = train_kernel_phase()
    print(f"[kernels] {time.perf_counter() - t_start:.1f} s", flush=True)
    cfg = flagship_config()
    serving = serving_phase(cfg, "cuda")
    emit({"serving": serving, "card": card})
    print(f"[serving] {serving['batches']} batches of {serving['batch']}: "
          f"{serving['mean_batch_latency_ms']:.2f} ms per batch, "
          f"{serving['answers_per_s']:.1f} answers/s on {card}", flush=True)
    generative = generative_phase(bench_serving.serving_config())
    emit({"generative": generative, "card": card})
    print("[generative] " + ", ".join(
        f"{k} {r['answers_per_sec']:.1f} answers/s p50 "
        f"{r['latency_ms_p50']:.1f} ms" for k, r in
        generative["results"].items())
        + f"; {generative['launches_per_generate']:.0f} attention launches "
          f"per generate on {card} ({time.perf_counter() - t_start:.1f} s)",
        flush=True)
    training = training_phase(cfg)
    emit({"training": training, "card": card})
    print(f"[training] batch {training['batch']}: median step "
          f"{training['median_step_ms']:.1f} ms, "
          f"{training['qa_pairs_per_s']:.1f} QA-pairs/s, peak "
          f"{training['max_memory_allocated_gib']:.1f} GiB on {card}",
          flush=True)
    check = train_check(cfg)
    emit({"train_check": check})
    print(f"[training] {time.perf_counter() - t_start:.1f} s", flush=True)

    tok = gen_tokenizer()
    gen_cfg = gen_training_config(tok)
    gen_rows = gen_train_kernel_phase(gen_cfg)
    gen_totals = step_totals(gen_rows)
    emit({"gen_training_attention_per_step": gen_totals, "card": card})
    gen_training = gen_training_phase(gen_cfg, tok)
    emit({"gen_training": gen_training, "card": card})
    print(f"[gen_training] batch {gen_training['batch']}: median step "
          f"{gen_training['median_step_ms']:.1f} ms (events "
          f"{gen_training['median_step_event_ms']:.1f}), "
          f"{gen_training['answer_tokens_per_s']:.1f} answer tokens/s, "
          f"{gen_training['qa_pairs_per_s']:.1f} QA-pairs/s, peak "
          f"{gen_training['max_memory_allocated_gib']:.1f} GiB; attention "
          f"per step " + ", ".join(f"{n} {t['ms']:.3f} ms" for n, t in
                                   gen_totals.items())
          + f" on {card}", flush=True)
    gen_check = gen_train_check(gen_cfg, tok)
    emit({"gen_train_check": gen_check})
    pipeline = pipeline_phase(gen_cfg, tok)
    emit({"gen_pipeline": pipeline})
    print(f"[gen_pipeline] {pipeline['steps']} steps and a validation in "
          f"{pipeline['seconds']:.1f} s: {pipeline['history'][0]}",
          flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    emit(kernels_line(rows, serving["launches"]["flash_attn_fwd"],
                      generative, train_rows, training["launches"], ptxas,
                      gen_rows, gen_training))
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
