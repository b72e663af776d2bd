"""The training slice of the port against the JAX package, on the CPU:
the loss, the weight-decay mask, the schedules, the gradient of a tiny
flagship-shaped model against ``jax.value_and_grad`` of bench.py's loss,
a few optimizer steps against the JAX train step, and the port's
training mode (dropout from an explicit generator)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_support import (assert_close, assert_close_bf16,
                                padding_mask, port_with)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu.train import losses as JL
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu.train import state as JS
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import (flatten_params, flax_paths,
                                             to_flax)
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.train import losses as PL
from vivqa_tpu_torch.train import optimizers as PO
from vivqa_tpu_torch.train import state as PS

torch.set_num_threads(1)


# -- loss --------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    {}, {"label_smoothing": 0.1}, {"ignore_index": 3},
    {"weights": True}, {"label_smoothing": 0.2, "ignore_index": 0,
                        "weights": True}], ids=str)
def test_cross_entropy_matches_jax(kwargs):
    rs = np.random.RandomState(0)
    logits = (3 * rs.standard_normal((4, 6, 10))).astype(np.float32)
    labels = rs.randint(0, 10, (4, 6))
    labels[0, :2] = 3
    labels[1, 0] = 0
    kw = dict(kwargs)
    weights = rs.rand(4, 6).astype(np.float32) if kw.pop("weights", False) \
        else None
    want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 weights=None if weights is None
                                 else jnp.asarray(weights), **kw)
    got = PL.cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                weights=None if weights is None
                                else torch.from_numpy(weights), **kw)
    assert got.dtype == torch.float32
    assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_perplexity_matches_jax():
    x = np.array([0.5, 3.0, 150.0], np.float32)
    assert_close(PL.perplexity(torch.from_numpy(x)),
                 JL.perplexity(jnp.asarray(x)), atol=0, rtol=1e-6)


def test_embedding_gradient_matches_matmul_grad_embed():
    """The table gradient of a bf16 lookup with repeated ids: the JAX
    package's one-hot matmul rounds it to bf16 once, the port sums in f32
    (ROADMAP.md, Queue C), so the two agree to a bf16 rounding."""
    from vivqa_tpu.ops.embedding import MatmulGradEmbed
    from vivqa_tpu_torch.ops.embedding import Embed
    rs = np.random.RandomState(9)
    ids = rs.randint(0, 20, (4, 12)).astype(np.int32)
    table = rs.standard_normal((20, 16)).astype(np.float32)
    g = rs.standard_normal((4, 12, 16)).astype(np.float32)
    jm = MatmulGradEmbed(20, 16, dtype=jnp.bfloat16)
    want = jax.grad(lambda t: jnp.sum(jm.apply(
        {"params": {"embedding": t}}, jnp.asarray(ids)).astype(jnp.float32)
        * g))(jnp.asarray(table))
    port = Embed(20, 16, torch.bfloat16)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(table))
    (port(torch.from_numpy(ids).long()).float() * torch.from_numpy(g)
     ).sum().backward()
    assert port.weight.grad.dtype == torch.float32
    assert_close_bf16(port.weight.grad, want, max_rel=2 ** -8,
                      mean_rel=2 ** -9, msg="table gradient")


# -- the tiny flagship-shaped model ------------------------------------------
def _config(mod):
    """The flagship's structure at dim 32, 1-2 layers, image 16, dropout 0,
    f32 wherever the config reaches (MCAN and the head's hidden layer stay
    bf16 by design)."""
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(backbone="clip", image_size=16,
                                       patch_size=8, hidden_dim=32,
                                       num_layers=2, num_heads=2,
                                       dtype="float32"),
        text=mod.TextEncoderConfig(backbone="phobert", vocab_size=50,
                                   hidden_dim=32, num_layers=2, num_heads=2,
                                   max_length=8, dtype="float32",
                                   dropout=0.0),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=0.0),
        moe=mod.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                               expert_hidden_dim=48),
        head=mod.AnswerHeadConfig(dropout=0.0),
        num_answers=10, dtype="float32")


def _batch(B=4, seed=0):
    rs = np.random.RandomState(seed)
    mask = padding_mask([8, 5, 2, 7][:B], 8)
    return {"pixel_values": rs.standard_normal((B, 16, 16, 3)).astype(
                np.float32),
            "input_ids": (rs.randint(4, 50, (B, 8)) * mask).astype(np.int32),
            "attention_mask": mask,
            "labels": rs.randint(0, 10, B).astype(np.int32)}


def _jax_loss_fn(params, batch, rng, apply_fn):
    """bench.py:104-110 with every dropout at 0: deterministic=True is the
    same forward (the MoE experts' dropout, 0.1 by ExpertConfig, cannot be
    set from VQAModelConfig, so the port sets it to 0 on its side)."""
    out = apply_fn({"params": params}, batch["pixel_values"],
                   batch["input_ids"], batch["attention_mask"],
                   deterministic=True)
    loss = JL.cross_entropy_loss(out["logits"], batch["labels"])
    return loss + 0.01 * out["aux_loss"], {}


@pytest.fixture(scope="module")
def pair():
    """The JAX model and its params (jitted init, then seeded noise on
    every leaf as test_torch_support.jax_params adds)."""
    b = _batch()
    jm = JModel(_config(JC))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)({"params": key, "router": key},
                                 b["pixel_values"], b["input_ids"],
                                 b["attention_mask"])
    rs = np.random.RandomState(1)
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))
    return jm, params


def _port(params):
    model = port_with(VietnameseVQAModel(_config(PC)), params).train()
    model.moe.dropout = 0.0
    return model


def _torch_batch(b):
    return {n: torch.from_numpy(a).long() if a.dtype.kind == "i"
            else torch.from_numpy(a) for n, a in b.items()}


# Leaves whose exact gradient is 0: a softmax ignores a shift of all its
# inputs by the attention key bias, or by AttFlat's one-glimpse bias.
ZERO_GRADIENT_LEAVES = ("/key/bias", "/att_fc2/bias")


def _grad_close(got: np.ndarray, want: np.ndarray, path: str,
                floor: float):
    """Gradients flow through the forced-bf16 MCAN and head, whose
    rounding (2**-8 relative) the two frameworks take at other points and
    which compounds over the layers; so each leaf's max and mean
    difference are held to 6% of its largest and mean element. ``floor``
    (1e-3 of the model's largest gradient element) covers the leaves
    whose exact gradient is 0 (attention key biases, AttFlat's one-glimpse
    bias: a softmax ignores a shift), where both sides hold rounding
    noise only. The router gate's gradient also moves where a token's
    2nd and 3rd expert are within bf16 noise and top-2 picks differently
    (the aux-loss rule of test_torch_model.py): it is held to 50% / 25%.
    A fault of layout or math shows as differences of 100%."""
    rel_max, rel_mean = (0.5, 0.25) if path == "moe/router/gate/kernel" \
        else (0.06, 0.06)
    diff = np.abs(got - want)
    assert diff.max() <= rel_max * np.abs(want).max() + floor, (
        f"{path}: max diff {diff.max()} vs max {np.abs(want).max()}")
    assert diff.mean() <= rel_mean * np.abs(want).mean() + floor, (
        f"{path}: mean diff {diff.mean()} vs mean {np.abs(want).mean()}")


def test_loss_and_every_gradient_match_jax(pair):
    jm, params = pair
    b = _batch()
    jb = {n: jnp.asarray(a) for n, a in b.items()}
    (want_loss, _), want_grads = jax.jit(
        jax.value_and_grad(_jax_loss_fn, has_aux=True),
        static_argnums=(3,))(params, jb, None, jm.apply)
    model = _port(params)
    loss, _ = PS.classification_loss_fn()(model, _torch_batch(b),
                                          torch.Generator().manual_seed(0))
    loss.backward()
    assert_close(loss, want_loss, atol=0, rtol=5e-3)     # the bf16 fusion
    want = flatten_params(jax.device_get(want_grads))
    names = dict(flax_paths(model))
    got = to_flax(model, {n: p.grad if p.grad is not None
                          else torch.zeros_like(p)
                          for n, p in model.named_parameters()},
                  {k: v.shape for k, v in want.items()})
    assert sorted(got) == sorted(want) and len(names) == len(want)
    floor = 1e-3 * max(np.abs(np.asarray(w)).max() for w in want.values())
    for path, w in want.items():
        _grad_close(got[path], np.asarray(w), path, floor)


def test_decay_mask_matches_jax(pair):
    _, params = pair
    want = flatten_params(jax.tree.map(np.asarray, JO.decay_mask(params)))
    model = _port(params)
    got = PO.decay_mask(model)
    paths = flax_paths(model)
    assert {paths[n]: v for n, v in got.items()} == {
        k: bool(v) for k, v in want.items()}
    assert 0 < sum(got.values()) < len(got)


def test_to_flax_inverts_load_flax_params(pair):
    _, params = pair
    model = _port(params)
    flat = flatten_params(params)
    back = to_flax(model, dict(model.named_parameters()),
                   {k: v.shape for k, v in flat.items()})
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


@pytest.mark.parametrize("name,extra", [
    ("warmup_cosine", {}), ("warmup_cosine", {"min_lr_ratio": 0.1}),
    ("warmup_linear", {}), ("polynomial", {"power": 2.0}),
    ("step", {"step_size": 4}), ("constant", {}),
    ("warmup_cosine", {"warmup_steps": 0, "warmup_ratio": 0.2}),
    ("warmup_cosine", {"warmup_steps": 50})], ids=str)
def test_schedule_matches_optax(name, extra):
    cfg = dict(name=name, warmup_steps=3, total_steps=20)
    cfg.update(extra)
    want = JO.create_schedule(JO.SchedulerConfig(**cfg), 1e-3)
    got = PO.create_schedule(PO.SchedulerConfig(**cfg), 1e-3)
    for step in range(25):
        # optax computes in f32, the port in f64
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {step}")


def test_train_steps_match_jax(pair):
    """Four steps of AdamW (lr 1e-3, warmup 2 of 10 steps, weight decay
    0.01 under the mask, clipping at 1.0) through each package's train
    step: loss and grad_norm per step within 1% (the bf16 fusion, as the
    loss in test_loss_and_every_gradient_match_jax). Adam moves each
    weight by about lr per step whatever its gradient's size, so where a
    gradient is bf16 noise the two may step opposite ways: every weight
    is held within 3 x the sum of the learning rates, and each leaf's mean
    difference to 10% of its mean update (the first update uses lr 0).
    The leaves whose exact gradient is 0 take Adam steps on rounding
    noise on both sides and are held to the first bound only."""
    jm, params = pair
    b = _batch(seed=3)
    jb = {n: jnp.asarray(a) for n, a in b.items()}
    opt_cfg = dict(learning_rate=1e-3)
    sched = dict(name="warmup_cosine", warmup_steps=2, total_steps=10)
    tx = JO.create_optimizer(JO.OptimizerConfig(**opt_cfg),
                             JO.SchedulerConfig(**sched), params=params)
    jstate = JS.TrainState.create(jm.apply, params, tx,
                                  jax.random.PRNGKey(0))
    jstep = jax.jit(JS.make_train_step(_jax_loss_fn))
    model = _port(params)
    state = PS.TrainState.create(
        model, PO.create_optimizer(PO.OptimizerConfig(**opt_cfg), model,
                                   PO.SchedulerConfig(**sched)), seed=0)
    step = PS.make_train_step(PS.classification_loss_fn())
    tb = _torch_batch(b)
    for i in range(4):
        jstate, jm_ = jstep(jstate, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-2, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-2,
                                   err_msg=f"grad_norm, step {i}")
    assert state.step == 4 and state.optimizer.count == 4
    want = flatten_params(jax.device_get(jstate.params))
    start = flatten_params(params)
    got = to_flax(model, dict(model.named_parameters()),
                  {k: v.shape for k, v in want.items()})
    lr_sum = sum(state.schedule(i) for i in range(4))
    for path, w in want.items():
        w = np.asarray(w)
        diff = np.abs(got[path] - w)
        update = np.abs(w - start[path]).mean()
        assert diff.max() <= 3 * lr_sum, (path, diff.max(), lr_sum)
        if not path.endswith(ZERO_GRADIENT_LEAVES):
            assert diff.mean() <= 0.1 * update, (path, diff.mean(), update)


def test_clip_and_grad_norm_follow_optax():
    """clip_by_global_norm scales only above the limit, by max/norm with
    no epsilon; the reported norm is the one before clipping."""
    lin = torch.nn.Linear(3, 2)
    for scale in (10.0, 1e-3):
        opt = PO.create_optimizer(PO.OptimizerConfig(learning_rate=0.0,
                                                     grad_clip_norm=1.0),
                                  lin)
        grads = [torch.full_like(p, scale) for p in lin.parameters()]
        for p, g in zip(lin.parameters(), grads):
            p.grad = g.clone()
        norm = opt.step()
        want = optax.global_norm([g.numpy() for g in grads])
        np.testing.assert_allclose(float(norm), float(want), rtol=1e-6)
        clipped, _ = optax.clip_by_global_norm(1.0).update(
            [g.numpy() for g in grads], optax.EmptyState())
        for p, c in zip(lin.parameters(), clipped):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(c),
                                       rtol=1e-6)


def test_optimizer_refuses_what_is_not_ported():
    """Every optimizer and option of the JAX package is ported (their
    parity: tests/test_torch_optim_zoo.py); what neither package knows
    raises ValueError, as optax's factory does."""
    lin = torch.nn.Linear(3, 2)
    for name in PO.OPTIMIZERS:
        PO.create_optimizer(PO.OptimizerConfig(
            name=name, lookahead=True, layer_decay=0.9,
            mu_dtype="bfloat16"), lin)
    with pytest.raises(ValueError, match="unknown optimizer"):
        PO.create_optimizer(PO.OptimizerConfig(name="lion"), lin)
    with pytest.raises(ValueError, match="mu_dtype"):
        PO.create_optimizer(PO.OptimizerConfig(mu_dtype="int8"), lin)
    with pytest.raises(ValueError, match="accumulate_steps"):
        PO.create_optimizer(PO.OptimizerConfig(accumulate_steps=0), lin)


# -- training mode -----------------------------------------------------------
def _dropout_model():
    """The tiny model with the flagship's dropout: 0.1 in the text
    encoder, MCAN (layers, attention probabilities, AttFlat), the MoE
    experts and the head."""
    from vivqa_tpu_torch.models.vqa_model import create_vqa_model
    cfg = _config(PC)
    cfg = cfg.replace(text=cfg.text.replace(dropout=0.1),
                      fusion=cfg.fusion.replace(dropout=0.1),
                      head=cfg.head.replace(dropout=0.1))
    return create_vqa_model(cfg, device="cpu")


def _train_run(seed: int, steps: int = 2):
    model = _dropout_model()
    state = PS.TrainState.create(
        model, PO.create_optimizer(PO.OptimizerConfig(learning_rate=1e-3),
                                   model, PO.SchedulerConfig(
                                       warmup_steps=1, total_steps=10)),
        seed=seed)
    step = PS.make_train_step(PS.classification_loss_fn())
    b = _torch_batch(_batch(seed=4))
    losses = [float(step(state, b)[1]["loss"]) for _ in range(steps)]
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def test_dropout_step_is_finite_and_repeats_bit_for_bit():
    la, pa = _train_run(seed=5)
    lb, pb = _train_run(seed=5)
    lc, pc = _train_run(seed=6)
    assert all(np.isfinite(la))
    assert la == lb and all(torch.equal(pa[n], pb[n]) for n in pa)
    assert la != lc                      # another seed, other masks


def test_training_forward_needs_a_generator_and_uses_only_it():
    model = _dropout_model().train()
    b = _torch_batch(_batch())
    args = (b["pixel_values"], b["input_ids"], b["attention_mask"])
    with pytest.raises(ValueError, match="Generator"):
        model(*args)
    torch.manual_seed(0)
    a = model(*args, generator=torch.Generator().manual_seed(1))["logits"]
    torch.manual_seed(1)                 # the global RNG plays no part
    b2 = model(*args, generator=torch.Generator().manual_seed(1))["logits"]
    c = model(*args, generator=torch.Generator().manual_seed(2))["logits"]
    assert torch.equal(a, b2) and not torch.equal(a, c)
    with torch.no_grad():
        e1 = model.eval()(*args)["logits"]
    assert not torch.equal(a, e1)


def test_eval_output_unchanged_by_training_path(pair):
    """model.eval() gives the serving forward of the first slice whether
    or not autograd records (the autograd Function's plain forward gives
    the same bits as attention_reference), and train() with every dropout
    at 0 gives the same logits (held against JAX by
    test_torch_model.py::test_vqa_model_matches_jax)."""
    _, params = pair
    model = _port(params)
    b = _torch_batch(_batch())
    args = (b["pixel_values"], b["input_ids"], b["attention_mask"])
    with torch.inference_mode():
        serving = model.eval()(*args)["logits"]
    recorded = model(*args)["logits"]
    assert recorded.grad_fn is not None
    torch.testing.assert_close(recorded, serving, rtol=0, atol=0)
    trained = model.train()(*args, generator=torch.Generator())["logits"]
    torch.testing.assert_close(trained, serving, rtol=0, atol=0)


def test_fold_in_gives_each_step_its_own_seed():
    seeds = {PS.fold_in(0, step) for step in range(100)}
    assert len(seeds) == 100 and all(0 <= s < 2 ** 63 for s in seeds)
    assert PS.fold_in(1, 0) != PS.fold_in(0, 0)
    assert PS.fold_in(7, 3) == PS.fold_in(7, 3)


def test_elementwise_dropout_follows_flax():
    """flax nn.Dropout: keep with probability 1 - rate, kept values scaled
    by 1 / (1 - rate), the rest 0; the identity without an rng."""
    from vivqa_tpu_torch.models.layers import DropoutRNG, dropout
    x = torch.ones(200, 300)
    assert dropout(x, 0.3, None) is x
    y = dropout(x, 0.3, DropoutRNG(torch.Generator().manual_seed(0)))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    sd = np.sqrt(0.3 * 0.7 / x.numel())
    assert abs(float(kept.float().mean()) - 0.7) < 5 * sd


def test_eval_step_runs_without_gradient(pair):
    _, params = pair
    model = _port(params)
    state = PS.TrainState.create(
        model, PO.create_optimizer(PO.OptimizerConfig(), model), seed=0)
    b = _torch_batch(_batch())

    def metric_fn(model, batch):
        out = model(batch["pixel_values"], batch["input_ids"],
                    batch["attention_mask"])
        return {"accuracy": (out["logits"].argmax(-1) == batch["labels"])
                .float().mean(), "requires_grad": out["logits"].requires_grad}
    metrics = PS.make_eval_step(metric_fn)(state, b)
    assert not model.training and not metrics["requires_grad"]
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
