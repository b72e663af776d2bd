"""Build variants of the port's attention kernels and time them on the card.

    python3 tools/attention_variants.py [--only NAME ...]

Each variant is one kernel source of the checkout
(``vivqa_tpu_torch/csrc/<source>.cu``) with a few text substitutions
(``VARIANTS``), and for the forward, optionally, other values of
``forward_plan``'s constants (``PLANS``): the design's alternatives that
PERF.md compares the final kernels with. Every variant is built at once,
its bf16 head-dim-64 parts alone (``VARIANT_PARTS``; the other dtypes and
head dims are left unlinked), with nvcc and the flags of
``vivqa_tpu_torch/ops/cuda_build.py`` into ``vivqa_tpu_torch/_build/``
(gitignored); the script prints ptxas' registers and spills of each
variant's templates, checks it against the plain version (except the
variants marked timing-only, which drop part of the computation) and
times it in bf16 (CUDA-graph replay, ``chip_smoke.device_ms``): the
forward's two entries at every main-path shape of
``tools/attention_times.py`` (the totals per serving forward, beam
generate and train step, and the long-key calls), the one-pass backward
per flagship train step at batch 128. The variants of one source are
timed in turns, twice, in opposite orders. One JSON line per variant
and round; needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
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
    ("fwd_final", "flash_attn_fwd", [], True),
    # one K/V stage: no key tile's loads ahead of the one in use inside a
    # block, and no tile's P V under the next tile's S and softmax
    ("fwd_ring1", "flash_attn_fwd",
     [("constexpr int kRing = 4;", "constexpr int kRing = 1;")], True),
    # two K/V stages (the consumers' overlap of P V with the next tile's S
    # holds both)
    ("fwd_ring2", "flash_attn_fwd",
     [("constexpr int kRing = 4;", "constexpr int kRing = 2;")], True),
    # two blocks an SM at 64-key tiles and D <= 64 (more registers a thread)
    ("fwd_blocks2", "flash_attn_fwd",
     [("constexpr int kBlocksPerSM = 3;", "constexpr int kBlocksPerSM = 2;")],
     True),
    # no key splits: the long form's units walk all their keys (the
    # wrapper still allocates the scratch, which goes unused)
    ("fwd_no_splits", "flash_attn_fwd",
     [("    a.tiles_per_split = tiles_per_split < a.n_kt ? tiles_per_split "
       ": a.n_kt;", "    a.tiles_per_split = a.n_kt;")], True),
    # every tile through the rules' path (no FMA-only softmax for tiles
    # whose keys no rule removes)
    ("fwd_rules_everywhere", "flash_attn_fwd",
     [("if (!kMask && !(p.causal && k0 + NK - 1 > rule.q_offset + q0)) {",
       "if (false) {")], True),
    # four blocks an SM at 64-key tiles and D <= 64 (fewer registers a
    # thread, a shallower ring)
    ("fwd_blocks4", "flash_attn_fwd",
     [("constexpr int kBlocksPerSM = 3;", "constexpr int kBlocksPerSM = 4;")],
     True),
    # 64-query units over 64-key tiles in the whole tile form (more than
    # 64 queries over 65 to 128 keys: the generative fusion's 113, the
    # zoo's 115, two units and two key tiles a (b, h)); PLANS
    ("fwd_tile_units64", "flash_attn_fwd", [], True),
    # 64-query units over 64-key tiles in the long form too; PLANS
    ("fwd_long_units64", "flash_attn_fwd", [], True),
    # no 32-key tiles: calls of at most 32 keys over 64-key tiles; PLANS
    ("fwd_no_narrow_tiles", "flash_attn_fwd", [], True),
    # the decode form up to 16 queries (the ablation study's 8- and
    # 16-query calls), its 4-row template compiled for 16; PLANS
    ("fwd_decode16", "flash_attn_fwd",
     [("constexpr int kDecRows = 4;", "constexpr int kDecRows = 16;")],
     True),
    # timing only: the staged mask is not applied to the scores
    ("fwd_mask_unused", "flash_attn_fwd",
     [("        if constexpr (kMask) kept = kept & ((keep[e >> 1][j] >> (8 * (e & 1)) "
       "& 0xffu) != 0u);\n", "")],
     False),
    # timing only: no dropout multiplier (the rate's keep hash not taken)
    ("fwd_no_dropout_hash", "flash_attn_fwd",
     [("        if (drop)\n", "        if (false)\n", 2)], False),
    # the dropout hash skipped for the 8-key groups past Lk (alike over a
    # warp)
    ("fwd_key_gated_dropout", "flash_attn_fwd",
     [("        if (drop)\n", "        if (drop && k0 + 8 * j < p.Lk)\n", 2)],
     True),
    # timing only: no o leaves the kernel (no TMA store)
    ("fwd_no_o_store", "flash_attn_fwd",
     [("  auto store_o = [&](int qs) {", "  auto store_o = [&](int qs) {\n    return;")],
     False),
    ("bwd_final", "flash_attn_bwd", [], True),
    # one query-tile stage (and one K/V slot): no unit's loads ahead of
    # the one in use inside a block
    ("bwd_ring1", "flash_attn_bwd",
     [("constexpr int kRing = 2;", "constexpr int kRing = 1;")], True),
    # three query-tile stages where they fit
    ("bwd_ring3", "flash_attn_bwd",
     [("constexpr int kRing = 2;", "constexpr int kRing = 3;")], True),
    # one block per unit instead of persistent blocks walking the units
    ("bwd_block_per_unit", "flash_attn_bwd",
     [("const int grid = a.n_units > resident ? resident : a.n_units;",
       "const int grid = a.n_units;")],
     True),
    # three one-warpgroup blocks an SM (fewer registers a thread)
    ("bwd_blocks3", "flash_attn_bwd",
     [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 3;")],
     True),
    # the scores' exponential by the fast approximate intrinsic
    ("bwd_fast_exp", "flash_attn_bwd",
     [("expf((ks == kKept", "__expf((ks == kKept")], True),
    # 64-query tiles in two steps of 32 queries
    ("bwd_steps32", "flash_attn_bwd",
     [("constexpr int kQS = 16;", "constexpr int kQS = 32;")], True),
    # the producer waits for its stats and mask copies before it arrives
    ("bwd_blocking_producer", "flash_attn_bwd",
     [("mbar_init(full(s), 65);", "mbar_init(full(s), 33);"),
      ("cp_async_arrive(full(s));  // and its copies, when they land",
       ""),
      ("mbar_arrive(full(s));      // this lane's element stores are done",
       "mma::cp_async_commit(); mma::cp_async_wait_all(); "
       "mbar_arrive(full(s));")], True),
    # timing only: the staged mask is not applied to the scores
    ("bwd_mask_unused", "flash_attn_bwd",
     [("!kMask || mrow[kl[r]] != 0", "true")], False),
    # timing only: the loads, the query records and the stores, no products
    ("bwd_loads_only", "flash_attn_bwd",
     [("for (int s0 = 0; s0 < kRows; s0 += kQS) {",
       "for (int s0 = 0; s0 < 0; s0 += kQS) {"),
      ("for (int job = warp; job < kJobs;", "for (int job = warp; job < 0;")],
     False),
    # timing only: every product, no TMA store of dq, dk or dv
    ("bwd_no_stores", "flash_attn_bwd",
     [("tma_store(&a.", "if (false) tma_store(&a.", 3)], False),
    # timing only: no dQ (the dS tile is written, dQ = dS K is not computed)
    ("bwd_no_dq", "flash_attn_bwd",
     [("for (int job = warp; job < kJobs;", "for (int job = warp; job < 0;")],
     False),
]


# forward_plan's constants a variant sets for its run (ops/flash_attention.py)
PLANS = {"fwd_tile_units64": {"WIDE_MIN_KEYS": 128},
         "fwd_long_units64": {"WIDE_MIN_KEYS": 1 << 30},
         "fwd_no_narrow_tiles": {"NARROW_MAX_KEYS": 0},
         "fwd_decode16": {"DECODE_MAX_QUERIES": 16}}

# The parts of each source a variant builds: its entry points (0) and the
# bf16, head-dim-64 launchers (``VIVQA_BUILDS_PART``)
VARIANT_PARTS = {"flash_attn_fwd": (0, 3, 4), "flash_attn_bwd": (0, 2)}


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
    """Compile the variant's parts at once and link them; the launchers of
    the parts left out stay undefined, so the library is loaded lazily
    and only its bf16, head-dim-64 calls may run."""
    source = next(v[1] for v in VARIANTS if v[0] == name)
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(variant_source(name))
    flags = [f for f in cuda_build.NVCC_FLAGS if f != "-shared"]
    nvcc = cuda_build.find_nvcc()
    objs = [out / f"{name}.part{i}.o" for i in VARIANT_PARTS[source]]
    procs = [subprocess.Popen(
        [nvcc, *flags, "-c", f"-DVIVQA_PART={i}", "-I",
         str(cuda_build.CSRC_DIR), "-o", str(obj), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, obj in zip(VARIANT_PARTS[source], objs)]
    report = "".join(proc.communicate(timeout=900)[0] for proc in procs)
    if any(proc.returncode != 0 for proc in procs):
        raise RuntimeError(f"nvcc failed for {name}:\n{report}")
    res = subprocess.run(
        [nvcc, "-shared", "-Xlinker", "--unresolved-symbols=ignore-all",
         "-o", str(lib), *map(str, objs)],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"link failed for {name}:\n{res.stdout}{res.stderr}")
    return lib, report


def main() -> int:
    import torch

    import chip_smoke as cs
    from vivqa_tpu_torch.ops import flash_attention as fa
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import attention_times

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
    forward = list(attention_times.forward_cases(gen))
    train = []
    for c in (c for c in cs.TRAIN_CASES if c[8]):
        q, k, v, mask = cs.attention_inputs(*c[1:7], torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        key = fa.dropout_key(2026, len(train))
        o, m, l = fa.attention_forward_lse_reference(q, k, v, mask, c[7],
                                                     c[9], key)
        train.append((c, (q, k, v, o.to(q.dtype), m, l, do, mask, c[7],
                          c[9], key)))

    def run(name, source, checked):
        per_call, totals, err = {}, {}, 0.0
        if source == "flash_attn_fwd":
            saved = {k: getattr(fa, k) for k in PLANS.get(name, {})}
            for k, v in PLANS.get(name, {}).items():
                setattr(fa, k, v)
            try:
                for kernel, group, case, fn, ref, calls in forward:
                    if checked:
                        got = fn()
                        got = got[0] if isinstance(got, tuple) else got
                        err = max(err, cs._grad_err(got, ref()))
                    us = cs.device_ms(fn) * 1e3
                    per_call[f"{kernel}/{case}"] = us
                    key = f"{kernel}/{group}"
                    totals[key] = totals.get(key, 0.0) + us * calls / 1e3
            finally:
                for k, v in saved.items():
                    setattr(fa, k, v)
            tol = cs.ATTN_TOL[torch.bfloat16]
        else:
            for c, a in train:
                def fn(a=a):
                    return fa.flash_attention_bwd_fused_cuda(*a)
                if checked:
                    want = fa.attention_backward_reference(*a)
                    err = max(err, *(cs._grad_err(g, w)
                                     for g, w in zip(fn(), want)))
                per_call[c[0]] = cs.device_ms(fn) * 1e3
                totals["flash_attn_bwd/flagship"] = totals.get(
                    "flash_attn_bwd/flagship", 0.0) + per_call[c[0]] * c[8] / 1e3
            tol = cs.GRAD_TOL[torch.bfloat16]
        if checked and not err <= tol:
            raise AssertionError(f"{name}: error {err} > {tol}")
        return per_call, totals, err if checked else None

    usage = {n: {t: u for t, u in cs.ptxas_usage(rep).items()
                 if "flash_attn_fwd_" in t or "flash_attn_bwd_kernel" in t}
             for n, (_, rep) in built.items()}
    sources = sorted({v[1] for v in chosen})
    for rnd in range(2):
        for source in sources:
            group = [v for v in chosen if v[1] == source]
            for name, _, _, checked in (group if rnd == 0 else group[::-1]):
                cuda_build._loaded[source] = ctypes.CDLL(
                    str(built[name][0]), mode=os.RTLD_LAZY)
                per_call, totals, err = run(name, source, checked)
                cs.emit({"variant": name, "round": rnd, "source": source,
                         "ms": totals, "us_per_call": per_call,
                         "max_err": err, "ptxas": usage[name]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
