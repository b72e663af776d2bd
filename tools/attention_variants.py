"""Build variants of the port's attention kernels and time them on the card.

    python3 tools/attention_variants.py [--only NAME ...]

Each variant is one kernel source of the checkout
(``vivqa_tpu_torch/csrc/<source>.cu``) with a few text substitutions
(``VARIANTS``): the design's alternatives that PERF.md compares the final
kernels with. Every variant is built at once with nvcc and the flags of
``vivqa_tpu_torch/ops/cuda_build.py`` into ``vivqa_tpu_torch/_build/``
(gitignored); the script prints ptxas' registers and spills of each
variant's bf16, head-dim-64 templates, checks it against the plain
version (except the variants marked timing-only, which drop part of the
computation) and times it in bf16 at the flagship's five shapes (CUDA-
graph replay, ``chip_smoke.device_ms``): the serving forward per
flagship forward at batch 8, dK/dV per train step at batch 128. The
variants of one source are timed in turns, twice, in opposite orders.
One JSON line per variant and round; needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vivqa_tpu_torch.ops import cuda_build  # noqa: E402

# (name, source, [(old text, new text[, occurrences]), ...], checked
# against the plain version); the first variant of each source is the
# checkout's own. A substitution must match exactly its number of
# occurrences (1 unless given).
VARIANTS = [
    ("serving_final", "flash_attn_fwd", [], True),
    # the serving template held to 128 registers (4 blocks of 64 rows an SM)
    ("serving_regs128", "flash_attn_fwd",
     [("(D == 64 ? 3 : 2) * mma::kTileRows / ROWS",
       "(D == 64 ? 4 : 2) * mma::kTileRows / ROWS")], True),
    # timing only: the staged mask is not applied to the scores
    ("serving_mask_unused", "flash_attn_fwd",
     [("!kMask || sM[(g + 8 * (e / 2)) * kMaskPitch + kc] != 0", "true")],
     False),
    ("dkv_final", "flash_attn_bwd_dkv", [], True),
    # 64-query tiles in two steps of 32 queries
    ("dkv_steps32", "flash_attn_bwd_dkv",
     [("constexpr int QS = 16;", "constexpr int QS = 32;")], True),
    # the mask tile's byte loads unrolled, as the forward has them
    ("dkv_mask_bytes_unrolled", "flash_attn_bwd_dkv",
     [("mma::kThreads, true>", "mma::kThreads>", 2)], True),
    # ... and the masked instantiation given 168 registers (3 blocks an SM)
    ("dkv_mask_bytes_unrolled_3_blocks", "flash_attn_bwd_dkv",
     [("mma::kThreads, true>", "mma::kThreads>", 2),
      ("D == 64 ? 4 : 2", "D == 64 ? (kMask ? 3 : 4) : 2")], True),
    # timing only: the staged mask is not applied to the scores
    ("dkv_mask_unused", "flash_attn_bwd_dkv",
     [("!kMask || sM[col * kMaskPitch + g + 8 * r] != 0", "true")], False),
]


def variant_source(name: str) -> str:
    """The variant's source text; raises if a substitution no longer
    matches the checkout's kernel."""
    _, source, subs, _ = next(v for v in VARIANTS if v[0] == name)
    text = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    for old, new, *count in subs:
        want = count[0] if count else 1
        if text.count(old) != want:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {source}.cu, not {want}")
        text = text.replace(old, new)
    return text


def build(name: str) -> tuple[Path, str]:
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(variant_source(name))
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
           "-I", str(cuda_build.CSRC_DIR), "-o", str(lib), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    return lib, res.stdout + res.stderr


def main() -> int:
    import torch

    import chip_smoke as cs
    from vivqa_tpu_torch.ops import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="variant names")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    chosen = [v for v in VARIANTS if not args.only or v[0] in args.only]
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(chosen)) as pool:
        built = dict(zip((v[0] for v in chosen),
                         pool.map(build, (v[0] for v in chosen))))
    print(f"[build] {len(chosen)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    serve = [(c, cs.attention_inputs(*c[1:7], torch.bfloat16, gen))
             for c in cs.ATTN_CASES if c[8]]
    train = []
    for c in (c for c in cs.TRAIN_CASES if c[8]):
        q, k, v, mask = cs.attention_inputs(*c[1:7], torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        key = fa.dropout_key(2026, len(train))
        o, m, l = fa.attention_forward_lse_reference(q, k, v, mask, c[7],
                                                     c[9], key)
        delta = (do.float() * o.float()).sum(-1)
        train.append((c, (q, k, v, m, l, do, delta, mask, c[7], c[9], key)))

    def run(name, source, checked):
        per_call, total, err = {}, 0.0, 0.0
        if source == "flash_attn_fwd":
            for c, (q, k, v, mask) in serve:
                def fn(q=q, k=k, v=v, mask=mask, causal=c[7]):
                    return fa.flash_attention_cuda(q, k, v, mask, causal)
                if checked:
                    ref = fa.attention_reference(q, k, v, mask, c[7])
                    err = max(err, float((fn().float() - ref.float())
                                         .abs().max()))
                per_call[c[0]] = cs.device_ms(fn) * 1e3
                total += per_call[c[0]] * c[8] / 1e3
            tol = cs.ATTN_TOL[torch.bfloat16]
        else:
            for c, a in train:
                def fn(a=a):
                    return fa.flash_attention_bwd_dkv_cuda(*a)
                if checked:
                    want = fa.attention_bwd_dkv_reference(*a)
                    err = max(err, *(cs._grad_err(g, w)
                                     for g, w in zip(fn(), want)))
                per_call[c[0]] = cs.device_ms(fn) * 1e3
                total += per_call[c[0]] * c[8] / 1e3
            tol = cs.GRAD_TOL[torch.bfloat16]
        if checked and not err <= tol:
            raise AssertionError(f"{name}: error {err} > {tol}")
        return per_call, total, err if checked else None

    usage = {n: {t: u for t, u in cs.ptxas_usage(rep).items()
                 if "mma" in t and "bfloat16Li64E" in t}
             for n, (_, rep) in built.items()}
    sources = sorted({v[1] for v in chosen})
    for rnd in range(2):
        for source in sources:
            group = [v for v in chosen if v[1] == source]
            for name, _, _, checked in (group if rnd == 0 else group[::-1]):
                cuda_build._loaded[source] = ctypes.CDLL(str(built[name][0]))
                per_call, total, err = run(name, source, checked)
                cs.emit({"variant": name, "round": rnd, "source": source,
                         "ms": total, "us_per_call": per_call,
                         "max_err": err, "ptxas": usage[name]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
