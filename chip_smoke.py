"""Drive the PyTorch port (vivqa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the port with nvcc for sm_90a, all at once,
   with ptxas' register and shared-memory report;
3. kernels: each kernel against its plain version on the card at the
   shapes the serving path gives it (and a few edge cases), one JSON line
   per case with its time, the plain version's, the bound and
   scaled_dot_product_attention's time as a yardstick;
4. serving: the flagship classification model (CLIP-style ViT-B/32,
   PhoBERT-style text encoder, MCAN, dense top-2 MoE, 1,000 answers) with
   seeded random weights behind VQAPredictor, answering batches of 8
   requests with questions of different lengths; every attention call
   must go through the kernel (36 launches per forward), and one batch is
   checked against the same weights on the CPU (the plain path); then
   one batch's forward eager, as one CUDA graph, and under torch.profiler
   (the device's busy time and idle share);
5. the card line (nvidia-smi's name and power limit), the kernels line,
   and the device line, which is the last line.

The script imports nothing of JAX or of the JAX package. Without a CUDA
device it prints no result and exits 2.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.eval.predictor import VQAPredictor
from vivqa_tpu_torch.models.config import (FusionConfig, MoEModelConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig)
from vivqa_tpu_torch.models.vqa_model import create_vqa_model
from vivqa_tpu_torch.ops import cuda_build
from vivqa_tpu_torch.ops import flash_attention as fa

# H100 SXM published peaks (NVIDIA data sheet, dense), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

KERNEL_SOURCES = ("flash_attn_fwd",)

# kernel vs plain version on the same inputs. bf16: the plain version
# rounds the probabilities to bf16 before P.V (as _xla_attention does),
# the kernel keeps them in f32; both round the output to bf16 (2**-8
# relative), so a few bf16 ulps of outputs of size <= ~2. f32: the same
# arithmetic in another order, f32 rounding only.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


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


# -- phase 2: build ----------------------------------------------------------
def build_phase() -> None:
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(cuda_build.build, KERNEL_SOURCES))
    for name, res in zip(KERNEL_SOURCES, results):
        print(f"[build] {name}: {res.seconds:.1f} s -> {res.library.name}")
        for line in res.report.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "spill" in line or "smem" in line):
                print(f"[build]   {line.strip()}")


# -- phase 3: kernels --------------------------------------------------------
def attention_inputs(B, H, Lq, Lk, D, kind, dtype, gen):
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rand(B, H, Lq, D), rand(B, H, Lk, D), rand(B, H, Lk, D)
    mask = None
    if kind is not None:
        klen = torch.randint(1, Lk + 1, (B,), generator=gen, device="cuda")
        kv = torch.arange(Lk, device="cuda")[None] < klen[:, None]
        if kind == "key":
            qv = torch.ones(B, Lq, dtype=torch.bool, device="cuda")
        else:   # query AND key padding, as the text encoder builds it
            qv = torch.arange(Lq, device="cuda")[None] < klen[:, None]
        mask = qv[:, None, :, None] & kv[:, None, None, :]
    return q, k, v, mask


def attention_work(q, k, mask, causal):
    """Bytes moved (q, k, v, o once, the mask once) and flops needed:
    4*D per (query, key) pair that enters the softmax; a row with no
    allowed key averages all Lk keys."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    allowed = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device=q.device)
    if causal:
        allowed = allowed & torch.ones(Lq, Lk, dtype=torch.bool,
                                       device=q.device).tril(Lk - Lq)
    if mask is not None:
        allowed = allowed & mask
    per_row = allowed.sum(-1)
    pairs = int(torch.where(per_row > 0, per_row, Lk).sum()) * H
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if mask is not None:
        nbytes += B * Lq * Lk
    return nbytes, 4 * D * pairs


def kernel_phase() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, B, H, Lq, Lk, D, kind, causal, calls in ATTN_CASES:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = attention_inputs(B, H, Lq, Lk, D, kind, dtype,
                                             gen)
            out = fa.flash_attention_cuda(q, k, v, mask, causal)
            ref = fa.attention_reference(q, k, v, mask, causal)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if not math.isfinite(err) or err > ATTN_TOL[dtype]:
                raise AssertionError(
                    f"{name} {dtype}: kernel vs plain max |err| {err} > "
                    f"{ATTN_TOL[dtype]}")
            errs[dtype] = err
        # timing and bounds at the main path's dtype, bf16
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
            return F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=sdpa_mask)
        times = {f"{label}_ms": device_ms(fn) for label, fn in
                 (("kernel", kernel), ("plain", plain), ("library", library))}
        times.update({f"{label}_eager_ms": eager_ms(fn) for label, fn in
                      (("kernel", kernel), ("library", library))})
        nbytes, flops = attention_work(q, k, mask, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
               "mask": kind, "causal": causal, "calls_per_forward": calls,
               "max_abs_err_bf16": errs[torch.bfloat16],
               "max_abs_err_f32": errs[torch.float32],
               "tol_bf16": ATTN_TOL[torch.bfloat16],
               "tol_f32": ATTN_TOL[torch.float32],
               **times, "bytes": nbytes, "flops": flops,
               "bound_us": max(t_bytes, t_flops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
        emit({"attention_case": row})
        rows[name] = row
    return rows


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
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    busy = sum(t for _, t in kernels.values()) / 1e3 / forwards
    attn = sum(t for n, (_, t) in kernels.items()
               if "flash_attn_fwd" in n) / 1e3 / forwards
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


def kernels_line(rows: dict, launches: int) -> dict:
    """One entry per kernel. Its numbers are for one flagship forward at
    batch 8: the 36 calls of the five serving shapes, each shape's time
    times its calls per forward."""
    main = [r for r in rows.values() if r["calls_per_forward"]]

    def total(key):
        return sum(r[key] * r["calls_per_forward"] for r in main)
    t_bytes = sum(r["bytes"] * r["calls_per_forward"] for r in main) \
        / HBM_BYTES_PER_S * 1e3
    t_flops = sum(r["flops"] * r["calls_per_forward"] for r in main) \
        / PEAK_FLOPS[torch.bfloat16] * 1e3
    return {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "vivqa_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "vivqa_tpu/ops/flash_attention.py:61 (_flash_kernel, "
                    "pallas_call at :127)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err_bf16"] for r in main),
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": total("library_ms"),
        "per": f"one flagship forward at batch 8 "
               f"({ATTN_CALLS_PER_FORWARD} calls), bf16"}]}


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

    build_phase()
    rows = kernel_phase()
    serving = serving_phase(flagship_config(), "cuda")
    emit({"serving": serving, "card": card})
    print(f"[serving] {serving['batches']} batches of {serving['batch']}: "
          f"{serving['mean_batch_latency_ms']:.2f} ms per batch, "
          f"{serving['answers_per_s']:.1f} answers/s on {card}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    emit(kernels_line(rows, serving["launches"]["flash_attn_fwd"]))
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
