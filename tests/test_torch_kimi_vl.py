"""The decoder-only VQA model on Kimi-VL-A3B's language model
(``models/decoder_vqa.py``, ``models/mla.py``, ``models/moe/routed.py``)
at tiny widths on the CPU, against the plain reference of
``kimi_vl_reference.py`` (one sample at a time, over its real tokens):
logits, loss and every gradient; the expert shares summing to the uncut
layer; the router; padding; the decay mask; spans and counters; the
generative pipeline; generation. The card test holds one MLA layer and
one MoE layer at the published widths against the reference; it skips
here.

This file imports no JAX, so the card runs it:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kimi_vl.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import kimi_vl_reference as ref
from benchmark.reference.train import decays
from vivqa_tpu_torch.models.config import (DecoderVQAConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.models.decoder_vqa import (DecoderVQAModel,
                                                create_decoder_vqa_model)
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.models.layers import init_weights
from vivqa_tpu_torch.models.mla import MultiHeadLatentAttention
from vivqa_tpu_torch.models.moe.routed import RoutedMoE
from vivqa_tpu_torch.train.optimizers import decay_mask
from vivqa_tpu_torch.train.state import generative_loss_fn
from vivqa_tpu_torch.utils import profiling

CFG = DecoderVQAConfig(
    visual=VisualEncoderConfig(image_size=32, patch_size=16, hidden_dim=64,
                               num_layers=1, num_heads=4, vit_style="clip",
                               activation="quick_gelu", dtype="float32"),
    vocab_size=64, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=2,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=16, experts_held=(0, 8), num_experts_per_tok=3,
    n_shared_experts=1, max_question_length=12, max_answer_length=8,
    dtype="float32")
C = CFG.to_dict()
Q_LEN, A_LEN = (3, 12, 7, 5), (2, 8, 4, 3)     # real tokens, BOS included


def batch_of(seed: int = 0, pad: int = 1) -> dict:
    """Right-padded questions and answers of the lengths above; labels
    are the answer shifted by one and EOS, -100 past it."""
    g = torch.Generator().manual_seed(seed)
    B, Lq, La = len(Q_LEN), CFG.max_question_length, CFG.max_answer_length
    q = torch.randint(4, CFG.vocab_size, (B, Lq), generator=g)
    a = torch.randint(4, CFG.vocab_size, (B, La + 1), generator=g)
    qm = (torch.arange(Lq)[None] < torch.tensor(Q_LEN)[:, None]).long()
    am = (torch.arange(La)[None] < torch.tensor(A_LEN)[:, None]).long()
    a[:, 0] = 0
    labels = a[:, 1:].clone()
    for b, n in enumerate(A_LEN):
        labels[b, n - 1] = 2
        labels[b, n:] = -100
    return {"pixel_values": torch.randn(B, 32, 32, 3, generator=g),
            "question_ids": torch.where(qm.bool(), q, pad),
            "question_mask": qm,
            "decoder_input_ids": torch.where(am.bool(), a[:, :-1], pad),
            "decoder_mask": am, "labels": labels}


def model_of(cfg: DecoderVQAConfig = CFG, seed: int = 0) -> DecoderVQAModel:
    model = create_decoder_vqa_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    # norms away from 1 and experts of the width's scale, so that every
    # leaf matters
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if name.endswith("ln_attn.weight") or name.endswith(
                    "ln_mlp.weight") or "ln_kv" in name or "ln_final" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            if "experts_w" in name:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
    return model


def params_of(model) -> dict:
    return {n: p.detach().clone().requires_grad_(True)
            for n, p in model.named_parameters()}


def test_port_matches_the_reference_logits_loss_and_gradients():
    model, batch = model_of().train(), batch_of()
    loss, metrics = generative_loss_fn(0.1, 0.0)(model, batch,
                                                 torch.Generator())
    loss.backward()
    p = params_of(model)
    want = ref.loss(p, C, batch, 0.1)
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    assert int(metrics["n_tokens"]) == sum(A_LEN)
    grads = torch.autograd.grad(want, list(p.values()), allow_unused=True)
    norms = [0.0 if g is None else float(g.norm()) for g in grads]
    floor = 1e-3 * sorted(norms)[len(norms) // 2]
    checked = 0
    for (name, param), g, norm in zip(model.named_parameters(), grads,
                                      norms):
        mine = torch.zeros_like(param) if param.grad is None else param.grad
        if norm < floor:
            # nought but rounding: the tower's key biases under the
            # softmax, its final LayerNorm (on the pooled path only)
            assert float(mine.norm()) < floor, name
            continue
        assert float((mine - g).norm()) <= 1e-4 * norm, name
        checked += 1
    assert checked == len(p) - 3
    with torch.no_grad():
        logits = model.eval()(batch["pixel_values"], batch["question_ids"],
                              batch["decoder_input_ids"],
                              batch["question_mask"],
                              batch["decoder_mask"])["logits"]
        for b, (qn, an) in enumerate(zip(Q_LEN, A_LEN)):
            got = ref.answer_logits(p, C, batch["pixel_values"][b],
                                    batch["question_ids"][b, :qn],
                                    batch["decoder_input_ids"][b, :an])
            assert torch.allclose(logits[b, :an], got, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shares", [[(0, 8), (8, 16)],
                                    [(0, 4), (4, 8), (8, 12), (12, 16)],
                                    [(0, 1), (1, 16)]])
def test_expert_shares_sum_to_the_uncut_layer(shares):
    """Each chip's layer holds experts [e0, e1) of 16 and routes over
    all 16: the shares' outputs, with the shared expert counted once,
    add up to the uncut reference's whole layer."""
    g = torch.Generator().manual_seed(3)
    D, F, E = 64, 32, 16
    stacks = {n: torch.randn(E, *s, generator=g) * s[0] ** -0.5
              for n, s in (("experts_w_gate", (D, F)),
                           ("experts_w_up", (D, F)),
                           ("experts_w_down", (F, D)))}
    first = None
    total = 0.0
    x = torch.randn(2, 11, D, generator=g)
    for e0, e1 in shares:
        layer = RoutedMoE(D, F, E, (e0, e1), 3, 1, 2.446,
                          dtype=torch.float32)
        if first is None:
            init_weights(layer, torch.Generator().manual_seed(4))
            first = layer
        else:
            layer.router.load_state_dict(first.router.state_dict())
            layer.shared.load_state_dict(first.shared.state_dict())
        with torch.no_grad():
            for n, t in stacks.items():
                getattr(layer, n).copy_(t[e0:e1])
        with torch.no_grad():
            total = total + layer(x)
    p = {f"moe.{n}": t for n, t in first.named_parameters()
         if not n.startswith("experts_w")}
    p.update({f"moe.{n}": t for n, t in stacks.items()})
    with torch.no_grad():
        shared = ref.swiglu(p, "moe.shared", x.reshape(-1, D))
        whole = ref.moe(p, "moe", x.reshape(-1, D),
                        dict(C, experts_held=(0, E)))
    total = total.reshape(-1, D) - (len(shares) - 1) * shared
    assert torch.allclose(total, whole, rtol=1e-5, atol=1e-5)


def test_router_selects_by_biased_score_and_weights_by_score():
    layer = RoutedMoE(64, 32, 16, (0, 8), 3, 1, 2.446, dtype=torch.float32)
    init_weights(layer, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    x = torch.randn(40, 64, generator=g)
    bias = torch.randn(16, generator=g) * 0.3
    layer.router.e_score_correction_bias.copy_(bias)
    idx, w = layer.router(x)
    s = torch.sigmoid(x @ layer.router.gate.weight.T)
    assert torch.equal(idx.sort(-1).values,
                       torch.topk(s + bias, 3).indices.sort(-1).values)
    unbiased = torch.topk(s, 3).indices.sort(-1).values
    assert not torch.equal(idx.sort(-1).values, unbiased)
    chosen = s.gather(1, idx)
    assert torch.allclose(w, 2.446 * chosen / chosen.sum(-1, keepdim=True))
    p = {f"moe.{n}": t for n, t in layer.named_parameters()}
    ridx, rw = ref.route(p, "moe", x, C, bias)
    assert torch.equal(ridx.sort(-1).values, idx.sort(-1).values)
    assert torch.allclose(rw.sort(-1).values, w.sort(-1).values)


def test_fitted_bias_evens_the_load_of_its_tokens():
    """Tokens that share one direction route to a few experts; the
    fitted bias gives each expert k/E of them."""
    layer = RoutedMoE(64, 32, 16, (0, 8), 3, 1, 2.446, dtype=torch.float32)
    init_weights(layer, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    x = torch.randn(400, 64, generator=g) + 3 * torch.randn(64, generator=g)
    load = lambda: torch.bincount(layer.router(x)[0].flatten(),
                                  minlength=16).float()
    before = load()
    assert float(before.max() / before.mean()) > 3.0
    layer.router.fit_bias(x)
    after = load()
    assert float(after.max() / after.mean()) < 1.1


def test_first_training_call_fits_a_zero_bias_once():
    """The first training call fits a bias still at zero on its first
    samples' real tokens before routing; later training calls and
    evaluation calls keep it, and a model handed it through the state
    dict (a checkpoint's) keeps it from its first call on. The reference
    routed by the same biases gives the same loss."""
    cfg = dataclasses.replace(CFG, bias_fit_samples=2)
    model = model_of(cfg).train()
    batch, other = batch_of(), batch_of(seed=9)
    loss, _ = generative_loss_fn(0.1, 0.0)(model, batch, torch.Generator())
    routers = [layer.moe.router for layer in model.layers[1:]]
    first = [r.e_score_correction_bias.clone() for r in routers]
    assert all(r.fitted and float(b.abs().sum()) > 0
               for r, b in zip(routers, first))
    want = ref.loss(params_of(model), C, batch, 0.1, bias=[None] + first)
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    # the fit sees only the first two samples
    changed = dict(batch, pixel_values=batch["pixel_values"].clone())
    changed["pixel_values"][2:] += 1.0
    fresh = model_of(cfg).train()
    generative_loss_fn(0.1, 0.0)(fresh, changed, torch.Generator())
    assert all(torch.equal(layer.moe.router.e_score_correction_bias, b)
               for layer, b in zip(fresh.layers[1:], first))
    generative_loss_fn(0.1, 0.0)(model, other, torch.Generator())
    with torch.no_grad():
        model.eval()(batch["pixel_values"], batch["question_ids"],
                     batch["decoder_input_ids"], batch["question_mask"])
    assert all(torch.equal(r.e_score_correction_bias, b)
               for r, b in zip(routers, first))
    state = model.state_dict()
    assert all(f"layers.{i}.moe.router.e_score_correction_bias" in state
               for i in (1, 2))
    resumed = model_of(cfg)
    resumed.load_state_dict(state)
    generative_loss_fn(0.1, 0.0)(resumed.train(), other, torch.Generator())
    assert all(torch.equal(layer.moe.router.e_score_correction_bias, b)
               for layer, b in zip(resumed.layers[1:], first))


def test_training_calls_move_the_bias_on_from_their_own_tokens():
    """With update iterations, each training call first moves the bias
    on by that many iterations of the fit over its first samples' real
    tokens (as the benchmark's reference does, from the same start),
    then routes by it; padding does not count, an evaluation call moves
    nothing."""
    from benchmark.reference.kimi_vl import fit_bias
    layer = RoutedMoE(64, 32, 16, (0, 8), 3, 1, 2.446, dtype=torch.float32,
                      fit_samples=1, update_iterations=3)
    init_weights(layer, torch.Generator().manual_seed(13))
    g = torch.Generator().manual_seed(14)
    x = torch.randn(2, 11, 64, generator=g)
    real = torch.arange(11)[None] < torch.tensor([[7], [4]])
    start = torch.randn(16, generator=g) * 0.1
    bias = layer.router.e_score_correction_bias
    bias.copy_(start)
    weight = layer.router.gate.weight
    want = fit_bias(torch.sigmoid(x[0, :7] @ weight.T), 3, start.clone(), 3)
    padded = fit_bias(torch.sigmoid(x[0] @ weight.T), 3, start.clone(), 3)
    assert not torch.allclose(want, padded)
    with torch.no_grad():
        before = layer.eval()(x, real)
        assert torch.equal(bias, start)
        during = layer.train()(x, real)
        assert torch.allclose(bias, want, atol=1e-6)
        after = layer.eval()(x, real)
    assert torch.equal(during, after) and not torch.equal(during, before)


def test_padding_is_not_routed_and_leaves_real_rows_alone():
    model = model_of().eval()
    a, b = batch_of(pad=1), batch_of(pad=37)
    assert not torch.equal(a["question_ids"], b["question_ids"])
    profiling.reset_counters()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        la = model(a["pixel_values"], a["question_ids"],
                   a["decoder_input_ids"], a["question_mask"],
                   a["decoder_mask"])["logits"]
    c = profiling.counters()
    profiling.reset_counters()
    with torch.no_grad():
        lb = model(b["pixel_values"], b["question_ids"],
                   b["decoder_input_ids"], b["question_mask"],
                   b["decoder_mask"])["logits"]
    for i, an in enumerate(A_LEN):
        assert torch.equal(la[i, :an], lb[i, :an])
    real = 4 * 4 + sum(Q_LEN) + sum(A_LEN)      # 4 image tokens a sample
    assert c["moe.routed"] == 2 * real * 3      # 2 MoE layers, top 3
    assert 0 < c["moe.held"] == c["moe.expert_rows"] < c["moe.routed"]
    assert 100 <= 100 * c["moe.held_peak"] / c["moe.held"] <= 800


def test_decay_mask_matches_the_benchmark_rule():
    model = model_of()
    mask = decay_mask(model)
    assert mask == {n: decays(n) for n, _ in model.named_parameters()}
    assert not any(mask[n] for n in mask if ".ln_" in n or "ln_final" in n
                   or n.startswith("token_embed") or n.endswith(".bias"))
    assert mask["lm_head.weight"] and mask["layers.1.moe.experts_w_down"]
    assert mask["layers.1.moe.router.gate.weight"]


def _spans(prof) -> list:
    return sorted(((e.name()[len("vivqa::"):], e.start_ns(),
                    e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()
                   and e.name().startswith("vivqa::")), key=lambda s: s[1])


def _inside(spans, outer) -> list:
    within = [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
              and s != outer]
    return [s[0] for s in within
            if not any(o[1] <= s[1] and s[2] <= o[2] and o != s
                       for o in within)]


def test_spans_and_counters_of_a_train_step():
    from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  SchedulerConfig,
                                                  create_optimizer)
    from vivqa_tpu_torch.train.state import TrainState, make_train_step
    model = model_of()
    opt = create_optimizer(OptimizerConfig(name="adamw"), model,
                           SchedulerConfig(warmup_steps=1, total_steps=4))
    state = TrainState.create(model, opt)
    step = make_train_step(generative_loss_fn(0.1, 0.0))
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch_of())
    c = profiling.counters()
    profiling.reset_counters()
    spans = _spans(prof)
    model_span = next(s for s in spans if s[0] == "model")
    assert _inside(spans, model_span) == ["vision", "projector", "lm",
                                          "head"]
    lm = next(s for s in spans if s[0] == "lm")
    assert _inside(spans, lm) == ["mla", "mlp", "mla", "moe", "mla", "moe"]
    moe = next(s for s in spans if s[0] == "moe")
    assert _inside(spans, moe) == ["router", "shared", "routed"]
    assert c["decoder.positions"] == c["decoder.labelled"] == sum(A_LEN)
    assert {"moe.routed", "moe.held", "moe.expert_rows",
            "moe.held_peak"} <= set(c)


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_generate_follows_teacher_forcing(strategy):
    """Each generated token is the argmax (greedy), or a beam's tokens
    score as the teacher-forced forward gives them (beam)."""
    model = model_of().eval()
    batch = batch_of()
    generate = build_generate_fn(model, DecodeConfig(
        max_length=5, strategy=strategy, num_beams=2, early_exit=False))
    seqs, scores = generate(batch["pixel_values"], batch["question_ids"],
                            batch["question_mask"])
    assert seqs.shape == (len(Q_LEN), 5)
    for b in range(len(Q_LEN)):
        row = seqs[b]
        stop = next((i + 1 for i, t in enumerate(row.tolist()) if t == 2),
                    len(row))
        inputs = torch.cat([torch.tensor([0]), row[:stop - 1]])[None]
        with torch.no_grad():
            logits = model(batch["pixel_values"][b:b + 1],
                           batch["question_ids"][b:b + 1], inputs,
                           batch["question_mask"][b:b + 1])["logits"][0]
        logp = torch.log_softmax(logits, -1)
        picked = logp.gather(1, row[:stop, None])[:, 0]
        if strategy == "greedy":
            assert torch.equal(logits.argmax(-1), row[:stop])
            assert float(scores[b]) == pytest.approx(float(picked.sum()),
                                                     rel=1e-4)
        else:
            pen = ((5.0 + stop) / 6.0) ** 0.6
            if 2 in row.tolist():
                assert float(scores[b]) == pytest.approx(
                    float(picked.sum()) / pen, rel=1e-4)


def test_generative_pipeline_trains_and_evaluates_the_model(tmp_path):
    from vivqa_tpu_torch.data import generate_synthetic_vivqa
    from vivqa_tpu_torch.pipelines.data_pipeline import DataPipelineConfig
    from vivqa_tpu_torch.pipelines.generative_training_pipeline import \
        GenerativeTrainingConfig
    from vivqa_tpu_torch.pipelines.generative_vqa_pipeline import (
        GenerativeVQAPipeline, GenerativeVQAPipelineConfig)
    csv, images = generate_synthetic_vivqa(tmp_path / "d", n=24,
                                           image_size=32)
    cfg = GenerativeVQAPipelineConfig(
        data=DataPipelineConfig(csv_path=str(csv), image_dir=str(images),
                                image_size=32, max_question_length=12,
                                max_answer_length=6, batch_size=8,
                                generative=True),
        model=CFG,
        training=GenerativeTrainingConfig(
            num_epochs=1, checkpoint_dir=str(tmp_path / "ck"), log_every=1,
            max_eval_batches=1),
        device="cpu", output_dir=str(tmp_path / "out"))
    again = GenerativeVQAPipelineConfig.from_dict(cfg.to_dict())
    assert again.model == CFG
    summary = GenerativeVQAPipeline(cfg).run()
    (epoch,) = summary["history"]
    assert epoch["train_loss"] > 0 and "bleu" in epoch
    assert (tmp_path / "out" / "pipeline_summary.json").is_file()


@pytest.mark.gpu
def test_card_mla_and_moe_layers_at_published_widths():
    """One MLA layer and one MoE layer (64 experts, 8 held, top 6) at the
    published widths on the card: in float32 (TF32 off) against the
    reference to float32 rounding; in bfloat16 to its rounding, the MoE
    on the tokens whose top 6 both sides chose alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = DecoderVQAConfig().to_dict()
    c.update(experts_held=(0, 8))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(4, 145, 2048, device=dev, generator=g)
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
        mla = MultiHeadLatentAttention(2048, 16, 512, 128, 64, 128, dtype)
        moe = RoutedMoE(2048, 1408, 64, (0, 8), 6, 2, 2.446, dtype=dtype)
        for m in (mla, moe):
            init_weights(m, torch.Generator().manual_seed(12))
            m.to(dev)
        from vivqa_tpu_torch.models.layers import rotary_table
        with torch.no_grad():
            got = mla(x.to(dtype), rotary_table(145, 64, 8e5).to(dev)).float()
            p = {f"attn.{n}": t for n, t in mla.named_parameters()}
            for b in range(4):
                want = ref.mla(p, "attn", x[b], c)
                err = (got[b] - want).norm() / want.norm()
                assert float(err) < tol, (dtype, b, float(err))
            flat = x.reshape(-1, 2048)
            got = moe(x.to(dtype)).float().reshape(-1, 2048)
            p = {f"moe.{n}": t for n, t in moe.named_parameters()}
            want = ref.moe(p, "moe", flat, c)
            same = (moe.router(flat.to(dtype))[0].sort(-1).values
                    == ref.route(p, "moe", flat, c)[0].sort(-1).values
                    ).all(-1)
            assert float(same.float().mean()) > 0.98
            err = (got[same] - want[same]).norm() / want[same].norm()
            assert float(err) < tol, (dtype, float(err))
