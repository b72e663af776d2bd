"""Time the attention backward of the checkout in the current directory.

    cd <checkout> && python3 <path to this file> LABEL

At the main paths' backward shapes (the flagship step's, the generative
step's, the knowledge calls, three of the zoo's, the ablation study's; bf16,
each path's dropout), runs the checkout's own
``chip_smoke.time_train_kernels``: each training kernel's CUDA-graph time
and bound, and SDPA's backward. Prints one JSON line per shape and one
with the totals per path (each shape times its calls). To compare two
commits on one card, unpack the other into a directory with ``git
archive`` and run both in one call, in turns. Needs one CUDA card and
nvcc.
"""
import json
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vivqa_tpu_torch.ops import cuda_build  # noqa: E402
from vivqa_tpu_torch.ops import flash_attention as fa  # noqa: E402

label = sys.argv[1]
t0 = time.perf_counter()
for source in cuda_build.PARTS:
    cuda_build.build(source)
print(f"[{label}] built in {time.perf_counter() - t0:.1f} s", flush=True)
gen = torch.Generator(device="cuda").manual_seed(11)
bf16 = torch.bfloat16


def rand(B, H, L, D):
    return torch.randn(B, H, L, D, generator=gen, device="cuda").to(bf16)


def cases():
    """(group, name, q, k, v, mask, causal, rate, calls a step)"""
    for name, B, H, Lq, Lk, D, kind, causal, calls, rate in cs.TRAIN_CASES:
        if calls:
            q, k, v, mask = cs.attention_inputs(B, H, Lq, Lk, D, kind, bf16,
                                                gen)
            yield "flagship", name, q, k, v, mask, causal, rate, calls
    gcfg = cs.gen_training_config(cs.gen_tokenizer())
    masks = cs.gen_train_masks(gcfg, cs.GEN_TRAIN_BATCH, gen)
    for name, B, H, Lq, Lk, kind, calls, rate in cs.gen_train_cases(
            gcfg, cs.GEN_TRAIN_BATCH):
        yield ("generative", name, rand(B, H, Lq, 64), rand(B, H, Lk, 64),
               rand(B, H, Lk, 64), None if kind is None else masks[kind],
               False, rate, calls)
    for name, B, H, Lq, Lk, kind, cls_calls, gen_calls, rate \
            in cs.RAG_TRAIN_CASES:
        yield ("knowledge", name, rand(B, H, Lq, 64), rand(B, H, Lk, 64),
               rand(B, H, Lk, 64), cs.knowledge_key_mask(B, Lk, kind, gen),
               False, rate, cls_calls + gen_calls)
    for name, B, H, Lq, Lk, kind, rate in cs.ZOO_TRAIN_CASES:
        if name in ("vision_tokens_b8", "stream_115_b32", "qf_cross_vit_b32"):
            q, k, v, mask = cs.attention_inputs(B, H, Lq, Lk, 64, kind, bf16,
                                                gen)
            yield "zoo", name, q, k, v, mask, False, rate, 1
    acfg = cs.abl_model_config()
    for name, B, H, Lq, Lk, D, kind, calls, rate in cs.abl_cases(
            acfg, cs.ABL_BATCH):
        mask = None if kind is None else cs.abl_masks(acfg, B, gen)[kind]
        yield ("ablation", name, rand(B, H, Lq, D), rand(B, H, Lk, D),
               rand(B, H, Lk, D), mask, False, rate, calls)


totals = {}
for group, name, q, k, v, mask, causal, rate, calls in cases():
    do = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
    t = cs.time_train_kernels(q, k, v, do, mask, causal, rate,
                              fa.dropout_key(2031, 0))
    bwd = [n for n in cs.TRAIN_KERNELS if n.startswith("flash_attn_bwd")]
    row = {"label": label, "group": group, "case": name,
           "shape": list(q.shape) + [k.shape[2]], "dropout": rate,
           "calls": calls,
           "kernel_us": {n: t[n]["kernel_ms"] * 1e3 for n in bwd},
           "bound_us": {n: t[n]["bound_ms"] * 1e3 for n in bwd},
           "sdpa_bwd_us": t[bwd[0]]["library_ms"] * 1e3}
    g = totals.setdefault(group, {"kernel_ms": 0.0, "sdpa_ms": 0.0,
                                  "bound_ms": 0.0, "calls": 0})
    g["kernel_ms"] += sum(row["kernel_us"].values()) * calls / 1e3
    g["bound_ms"] += sum(row["bound_us"].values()) * calls / 1e3
    g["sdpa_ms"] += row["sdpa_bwd_us"] * calls / 1e3
    g["calls"] += calls
    print(json.dumps(row), flush=True)
print(json.dumps({"label": label, "totals": totals,
                  "seconds": time.perf_counter() - t0}), flush=True)
