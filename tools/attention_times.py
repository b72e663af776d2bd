"""Time the attention kernels of the checkout in the current directory.

    cd <checkout> && python3 <path to this file> LABEL

At the main paths' shapes, bf16, CUDA-graph replay
(``chip_smoke.device_ms``), beside scaled_dot_product_attention and the
bound:

- the serving forward (``flash_attention_cuda``): the flagship forward's
  calls at batch 8, the beam generate's at batch 16 (its decode calls
  over the cache at the middle step), and the long-key calls a call
  each: ``long_1024``, the zoo's 32 x 784 vision tokens, DINOv2's 1,370;
- the training kernels (``chip_smoke.time_train_kernels``: the forward
  with stats and the backward): the flagship step's calls at batch 128,
  the generative step's at 32, the knowledge calls, three of the zoo's
  (the vision tokens among them) and the ablation study's, each at its
  path's dropout, and the training forward at ``long_1024``.

Prints one JSON line per shape and one with the totals per group (each
shape times its calls). It calls only functions that earlier checkouts of
the port have too, so to compare two commits on one card, unpack the
other into a directory with ``git archive`` and run both in one call, in
turns. Needs one CUDA card and nvcc. ``tools/attention_variants.py`` times
its variants of the forward at the same shapes (``forward_cases``).
"""
import json
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vivqa_tpu_torch.ops import cuda_build  # noqa: E402
from vivqa_tpu_torch.ops import flash_attention as fa  # noqa: E402

bf16 = torch.bfloat16


def bound_us(nbytes, flops):
    return max(nbytes / cs.HBM_BYTES_PER_S,
               flops / cs.PEAK_FLOPS[bf16]) * 1e6


def serving_cases(gen):
    """(group, name, q, k, v, mask, causal, calls a pass)"""
    for name, B, H, Lq, Lk, D, kind, causal, calls in cs.ATTN_CASES:
        if calls or name == "long_1024":
            q, k, v, mask = cs.attention_inputs(B, H, Lq, Lk, D, kind, bf16,
                                                gen)
            yield ("serving_forward" if calls else "long_keys", name, q, k,
                   v, mask, causal, calls)
    for name, B, H, Lq, Lk, D, kind, _, calls in cs.GEN_CASES:
        if calls:
            cur = cs.CACHE_INDICES[1] if kind == "cache_pos" else None
            q, k, v, mask = cs.attention_inputs(B, H, Lq, Lk, D, kind, bf16,
                                                gen, cur)
            yield "beam_generate_b16", name, q, k, v, mask, False, calls
    for name, B, H, Lq, Lk, D, kind in cs.ZOO_FWD_CASES + cs.HF_FWD_CASES:
        if name in ("vision_tokens", "hf_dinov2_518"):
            q, k, v, mask = cs.attention_inputs(B, H, Lq, Lk, D, kind, bf16,
                                                gen)
            yield "long_keys", name, q, k, v, mask, False, 0


def training_cases(gen):
    """(group, name, q, k, v, mask, causal, rate, calls a step)"""
    def rand(B, H, L, D):
        return torch.randn(B, H, L, D, generator=gen, device="cuda").to(bf16)

    for name, B, H, Lq, Lk, D, kind, causal, calls, rate in cs.TRAIN_CASES:
        if calls or name == "long_1024":
            q, k, v, mask = cs.attention_inputs(B, H, Lq, Lk, D, kind, bf16,
                                                gen)
            yield ("flagship" if calls else "long_keys", name, q, k, v, mask,
                   causal, rate or 0.0, calls)
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


def forward_cases(gen):
    """Both forward entries at the shapes above: (kernel, group, name,
    call, reference, calls), ``call`` the kernel's call (o, or (o, m, l)
    with stats), ``reference`` its plain version's o in f32."""
    for group, name, q, k, v, mask, causal, calls in serving_cases(gen):
        yield ("flash_attn_fwd", group, name,
               lambda q=q, k=k, v=v, mask=mask, causal=causal:
               fa.flash_attention_cuda(q, k, v, mask, causal),
               lambda q=q, k=k, v=v, mask=mask, causal=causal:
               fa.attention_reference(q, k, v, mask, causal), calls)
    for i, (group, name, q, k, v, mask, causal, rate, calls) in enumerate(
            training_cases(gen)):
        key = fa.dropout_key(2031, i)
        yield ("flash_attn_fwd_lse", group, name,
               lambda q=q, k=k, v=v, mask=mask, causal=causal, rate=rate,
               key=key: fa.flash_attention_fwd_lse_cuda(q, k, v, mask, causal,
                                                        rate, key),
               lambda q=q, k=k, v=v, mask=mask, causal=causal, rate=rate,
               key=key: fa.attention_forward_lse_reference(
                   q, k, v, mask, causal, rate, key)[0], calls)


def main(label: str) -> None:
    t0 = time.perf_counter()
    for source in cuda_build.PARTS:
        cuda_build.build(source)
    print(f"[{label}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    totals = {}

    def add(group, calls, **us):
        g = totals.setdefault(group, {k: 0.0 for k in us} | {"calls": 0})
        for k, v in us.items():
            g[k] += v * calls / 1e3
        g["calls"] += calls

    for group, name, q, k, v, mask, causal, calls in serving_cases(gen):
        B, H, Lq, D = q.shape
        Lk = k.shape[2]
        sdpa_mask = mask
        if causal:
            tri = torch.ones(Lq, Lk, dtype=torch.bool, device="cuda").tril(
                Lk - Lq)
            sdpa_mask = tri if mask is None else mask & tri
        nbytes, flops, _ = cs.attention_work(q, k, mask, causal)
        row = {"label": label, "kernel": "flash_attn_fwd", "group": group,
               "case": name, "shape": [B, H, Lq, Lk, D], "calls": calls,
               "kernel_us": cs.device_ms(lambda: fa.flash_attention_cuda(
                   q, k, v, mask, causal)) * 1e3,
               "sdpa_us": cs.device_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=sdpa_mask)) * 1e3,
               "bound_us": bound_us(nbytes, flops)}
        add("flash_attn_fwd/" + group, calls, **{
            k.replace("_us", "_ms"): row[k]
            for k in ("kernel_us", "sdpa_us", "bound_us")})
        print(json.dumps(row), flush=True)

    for group, name, q, k, v, mask, causal, rate, calls in training_cases(
            gen):
        do = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        t = cs.time_train_kernels(q, k, v, do, mask, causal, rate,
                                  fa.dropout_key(2031, 0))
        for kernel in cs.TRAIN_KERNELS:
            row = {"label": label, "kernel": kernel, "group": group,
                   "case": name,
                   "shape": list(q.shape) + [k.shape[2]], "dropout": rate,
                   "calls": calls,
                   "kernel_us": t[kernel]["kernel_ms"] * 1e3,
                   "sdpa_us": t[kernel]["library_ms"] * 1e3,
                   "bound_us": t[kernel]["bound_ms"] * 1e3}
            add(f"{kernel}/{group}", calls, **{
                k.replace("_us", "_ms"): row[k]
                for k in ("kernel_us", "sdpa_us", "bound_us")})
            print(json.dumps(row), flush=True)
    print(json.dumps({"label": label, "totals": totals,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
