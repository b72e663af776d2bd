"""The optimizer zoo of the port (``vivqa_tpu_torch/train/optimizers.py``)
against the JAX package's optax chains (``vivqa_tpu/train/optimizers.py``)
over 4-7 updates from the same seeded gradients: every optimizer, with
and without a freeze mask, layer-wise decay, lookahead and a bf16 first
moment; the optimizer state carried from optax through the weight
bridge; and the layout that adafactor factors.

The model is tiny but has the leaves that matter: an attention block of
width 128 and 2 heads, whose flax query/key/value kernels are (128, 2,
64) DenseGeneral leaves that adafactor does not factor (its second
largest dimension is 64 < 128) while the port's (128, 128) weight would
be factored; a (128, 256) MLP kernel that both factor; LayerNorms and
biases that the decay mask leaves out; ``layers_<i>`` paths for the
layer-wise decay; and the top-level names the freezing strategies read.
f32 throughout: parameters agree to 1e-5 after every update.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_support import assert_close_bf16
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu.train import strategies as JS
from vivqa_tpu_torch.models import from_jax as FJ
from vivqa_tpu_torch.models.layers import (Dense, LayerNorm,
                                           MultiHeadDotProductAttention)
from vivqa_tpu_torch.train import optimizers as PO
from vivqa_tpu_torch.train import strategies as PS

torch.set_num_threads(1)
TOL = 1e-5
LR = 1e-2


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(128, 2, dtype=torch.float32)
        self.ln = LayerNorm(128, dtype=None)
        self.mlp = Dense(128, 256, dtype=torch.float32)


class _Tower(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.layers = nn.ModuleList([_Block() for _ in range(n)])


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.visual_encoder = _Tower(2)
        self.text_encoder = _Tower(1)
        self.answer_head = Dense(128, 16, dtype=torch.float32)


def _model() -> nn.Module:
    torch.manual_seed(0)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _flax_tree(model: nn.Module, tensors: dict) -> dict:
    """{torch name: tensor} -> the nested flax tree (numpy, flax layout)."""
    layouts, paths, out = FJ.flax_layouts(model), FJ.flax_paths(model), {}
    for name, t in tensors.items():
        node = out
        *heads, leaf = paths[name].split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[leaf] = FJ.to_flax_view(layouts[name], t.detach()).numpy().copy()
    return out


def _grads(model: nn.Module, rs) -> dict:
    return {n: torch.from_numpy(0.1 * rs.standard_normal(p.shape)
                                .astype(np.float32))
            for n, p in model.named_parameters()}


class _Pair:
    """One optimizer config in both packages over one model's weights;
    ``update`` applies the same gradients to both."""

    def __init__(self, cfg: dict, strategy: str | None = None,
                 sched: dict | None = None):
        self.model = _model()
        self.params = dict(self.model.named_parameters())
        self.start = {n: p.detach().clone() for n, p in self.params.items()}
        self.jparams = jax.tree.map(jnp.asarray,
                                    _flax_tree(self.model, self.params))
        jfreeze = JS.trainable_mask(self.jparams, strategy) \
            if strategy else None
        self.freeze = PS.trainable_mask(self.model, strategy) \
            if strategy else None
        self.tx = JO.create_optimizer(
            JO.OptimizerConfig(**cfg),
            JO.SchedulerConfig(**sched) if sched else None,
            params=self.jparams, freeze_mask=jfreeze)
        self.jstate = self.tx.init(self.jparams)
        # jitted, as the JAX train step runs it: XLA's fusions decide the
        # roundings of a bf16 moment; the f32 chains run op by op (no
        # compile, the same numbers to 1e-7)
        self.jupdate = (jax.jit(self.tx.update)
                        if cfg.get("mu_dtype") == "bfloat16"
                        else self.tx.update)
        self.opt = PO.create_optimizer(
            PO.OptimizerConfig(**cfg), self.model,
            PO.SchedulerConfig(**sched) if sched else None, self.freeze)
        self.rs = np.random.RandomState(1)

    def update(self, steps: int = 1):
        for _ in range(steps):
            grads = _grads(self.model, self.rs)
            upd, self.jstate = self.jupdate(
                jax.tree.map(jnp.asarray, _flax_tree(self.model, grads)),
                self.jstate, self.jparams)
            self.jparams = optax.apply_updates(self.jparams, upd)
            for n, p in self.params.items():
                p.grad = grads[n].clone()
            self.norm = self.opt.step()
            self.want_norm = optax.global_norm(
                [g.numpy() for g in grads.values()])

    def port_tree(self) -> dict:
        return FJ.flatten_params(_flax_tree(self.model, self.params))

    def jax_tree(self) -> dict:
        return FJ.flatten_params(jax.device_get(self.jparams))

    def max_diff(self) -> float:
        got, want = self.port_tree(), self.jax_tree()
        return max(float(np.abs(got[k] - np.asarray(want[k])).max())
                   for k in want)


CASES = {
    "adamw": dict(name="adamw"),
    "adam": dict(name="adam"),
    "sgd": dict(name="sgd"),
    "radam": dict(name="radam"),
    # b2 0.9 reaches optax's rectification threshold (ro >= 5) at update
    # 6, which the default b2 reaches only past update 5
    "radam_rectified": dict(name="radam", beta2=0.9),
    "lamb": dict(name="lamb"),
    "adafactor": dict(name="adafactor"),
    "adamw_layer_decay": dict(name="adamw", layer_decay=0.9),
    "adafactor_layer_decay": dict(name="adafactor", layer_decay=0.8),
    "adamw_lookahead": dict(name="adamw", lookahead=True, lookahead_sync=2),
    "sgd_lookahead": dict(name="sgd", lookahead=True, lookahead_sync=3,
                          lookahead_slow_step=0.3),
    # without clipping the two packages see bit-equal gradients, so the
    # bf16 roundings of μ fall alike
    "adamw_bf16_mu": dict(name="adamw", mu_dtype="bfloat16",
                          grad_clip_norm=0.0),
    "adam_bf16_mu": dict(name="adam", mu_dtype="bfloat16",
                         grad_clip_norm=0.0),
}


@pytest.mark.parametrize("case,strategy", [
    (case, strategy) for case in CASES for strategy in (None, "freeze_visual")
    # the JAX chain raises for layer_decay under a freeze mask
    # (test_layer_decay_under_a_freeze_mask)
    if not (case.endswith("layer_decay") and strategy)])
def test_optimizer_matches_optax(case, strategy):
    """Every parameter after each of 4 updates (7 for the rectified
    RAdam) of a warmup-cosine schedule within 1e-5 of optax's; frozen
    parameters bit-equal to their start; grad_norm over every gradient,
    frozen ones too."""
    cfg = dict(learning_rate=LR, **CASES[case])
    pair = _Pair(cfg, strategy, dict(name="warmup_cosine", warmup_steps=1,
                                     total_steps=10))
    for i in range(7 if case == "radam_rectified" else 4):
        pair.update()
        assert pair.max_diff() < TOL, (case, i, pair.max_diff())
        np.testing.assert_allclose(float(pair.norm), float(pair.want_norm),
                                   rtol=1e-6)
    for n, trainable in (pair.freeze or {}).items():
        if not trainable:
            assert torch.equal(pair.params[n].detach(), pair.start[n]), n
    assert pair.opt.count == (7 if case == "radam_rectified" else 4)


@pytest.mark.parametrize("strategy", [None, "freeze_visual"])
def test_adafactor_bf16_momentum_follows_optax(strategy):
    """adafactor's momentum EMA stored in bf16: the update before the EMA
    differs from optax's by float roundings, so a stored bf16 value can
    round the other way; the updates agree to a bf16 rounding."""
    pair = _Pair(dict(name="adafactor", learning_rate=LR,
                      mu_dtype="bfloat16"), strategy)
    pair.update(4)
    start = FJ.flatten_params(_flax_tree(pair.model, pair.start))
    got, want = pair.port_tree(), pair.jax_tree()
    for k in want:
        assert_close_bf16(got[k] - start[k], np.asarray(want[k]) - start[k],
                          msg=k)
    assert all(t.dtype == torch.bfloat16 for t in pair.opt.state["ema"])


def test_layer_decay_under_a_freeze_mask():
    """The JAX chain cannot scale a masked update tree by the full scale
    tree (``_scale_by_tree`` under ``multi_transform`` raises): a
    reference fault. The port scales the trainable updates; without
    clipping (which a mask changes) they equal the JAX package's updates
    of the same leaves with no freeze mask."""
    cfg = dict(name="adamw", learning_rate=LR, layer_decay=0.9,
               grad_clip_norm=0.0)
    with pytest.raises(ValueError):
        _Pair(cfg, "freeze_visual").update()
    free = _Pair(cfg)
    frozen = _Pair(cfg)
    frozen.opt = PO.create_optimizer(
        PO.OptimizerConfig(**cfg), frozen.model,
        freeze_mask=PS.trainable_mask(frozen.model, "freeze_visual"))
    free.update(4)
    frozen.update(4)
    got, want = frozen.port_tree(), free.jax_tree()
    start = FJ.flatten_params(_flax_tree(frozen.model, frozen.start))
    for k in want:
        if k.startswith("visual_encoder"):
            np.testing.assert_array_equal(got[k], start[k])
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["adamw_lookahead", "adafactor",
                                  "adamw_bf16_mu", "sgd", "lamb"])
def test_state_carried_from_optax(case):
    """Two updates in optax, the state read by
    ``from_jax.optax_state_arrays`` and laid into the port's optimizer,
    the weights copied: two more updates agree to 1e-5, and every state
    field (μ, ν, the trace, adafactor's factored rows and columns and
    EMA, the lookahead's slow copy) equals optax's after them."""
    cfg = dict(learning_rate=LR, **CASES.get(case, dict(name=case)))
    pair = _Pair(cfg)
    rs = np.random.RandomState(5)
    for _ in range(2):
        grads = jax.tree.map(jnp.asarray, _flax_tree(
            pair.model, _grads(pair.model, rs)))
        upd, pair.jstate = pair.jupdate(grads, pair.jstate, pair.jparams)
        pair.jparams = optax.apply_updates(pair.jparams, upd)
    FJ.load_flax_params(pair.model, jax.device_get(pair.jparams))
    arrays = FJ.optax_state_arrays(jax.device_get(pair.jstate))
    # sgd without a schedule keeps no count (optax.trace has none)
    count = 0 if case == "sgd" else 2
    assert arrays["count"] == count
    pair.opt.load_fields(FJ.optimizer_state_from_flax(pair.model, arrays))
    assert pair.opt.count == count
    pair.update(2)
    assert pair.max_diff() < TOL
    want = FJ.optimizer_state_from_flax(
        pair.model, FJ.optax_state_arrays(jax.device_get(pair.jstate)))
    fields = dict(pair.opt.state)
    if pair.opt.slow is not None:
        fields["slow"] = pair.opt.slow
    assert set(want) - {"count"} == {f for f, ts in fields.items() if ts}
    for field, ts in fields.items():
        for n, t in zip(pair.opt.names, ts):
            np.testing.assert_allclose(t.float().numpy(),
                                       want[field][n].numpy(), atol=TOL,
                                       rtol=1e-5, err_msg=f"{field} {n}")


def test_adafactor_factors_the_flax_leaves():
    """The attention kernels are (128, 2, 64) in flax: not factored, so
    their second moment is a full v of the weight's shape; the MLP kernel
    (128, 256) is factored into a row of 128 and a column of 256, as
    optax's state holds them."""
    model = _model()
    opt = PO.create_optimizer(PO.OptimizerConfig(name="adafactor"), model)
    st = dict(zip(opt.names, zip(opt.state["v_row"], opt.state["v_col"],
                                 opt.state["v"])))
    q = "visual_encoder.layers.0.attn.query.weight"
    mlp = "visual_encoder.layers.0.mlp.weight"
    assert FJ.flax_layouts(model)[q][2] == (128, 2, 64)
    assert PO.factored_dims((128, 2, 64)) is None
    assert PO.factored_dims(tuple(model.get_parameter(q).shape)) is not None
    assert st[q][2].shape == (128, 128) and st[q][0].shape == (1,)
    assert st[mlp][0].shape == (128,) and st[mlp][1].shape == (256,)
    jstate = optax.adafactor(1e-2, multiply_by_parameter_scale=False,
                             clipping_threshold=None).init(
        _flax_tree(model, dict(model.named_parameters())))
    arrays = FJ.optax_state_arrays(jstate)
    path = FJ.flax_paths(model)
    assert arrays["v_row"][path[mlp]].shape == (128,)
    assert arrays["v"][path[q]].shape == (128, 2, 64)


def test_leaves_map_one_to_one():
    model = _model()
    ref = FJ.flatten_params(_flax_tree(model, dict(model.named_parameters())))
    FJ.check_one_to_one(model, {k: v.shape for k, v in ref.items()})
    ref["answer_head/kernel"] = np.zeros((16, 128))
    with pytest.raises(ValueError, match="not flax's"):
        FJ.check_one_to_one(model, {k: v.shape for k, v in ref.items()})
    with pytest.raises(ValueError, match="unknown optimizer"):
        PO.create_optimizer(PO.OptimizerConfig(name="lion"), model)
    with pytest.raises(ValueError, match="mu_dtype"):
        PO.create_optimizer(PO.OptimizerConfig(mu_dtype="float16"), model)


def test_layer_decay_scales_follow_the_flax_paths():
    model = _model()
    got = PO.layer_decay_scales(model, 0.5)
    want = JO.layer_decay_scales(_flax_tree(
        model, dict(model.named_parameters())), 0.5)
    want = FJ.flatten_params(jax.tree.map(np.asarray, want))
    paths = FJ.flax_paths(model)
    assert {paths[n]: s for n, s in got.items()} == \
        {k: float(v) for k, v in want.items()}
    assert got["visual_encoder.layers.0.mlp.weight"] == 0.5
    assert got["answer_head.weight"] == 1.0


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_dict_round_trip(name):
    """``state_dict`` / ``load_state_dict`` carry the moments (or the
    factored rows and columns), the count, the accumulator and the
    lookahead's slow copy: a restored optimizer continues bit for bit."""
    cfg = PO.OptimizerConfig(learning_rate=LR, name=name, lookahead=True,
                             lookahead_sync=3, accumulate_steps=2)
    models = [_model(), _model()]
    opts = [PO.create_optimizer(cfg, m) for m in models]

    def steps(i, n, rs):
        for _ in range(n):
            grads = _grads(models[i], rs)
            for k, p in models[i].named_parameters():
                p.grad = grads[k]
            opts[i].step()
    for i in (0, 1):
        steps(i, 3, np.random.RandomState(1))
    saved = opts[1].state_dict()
    opts[1] = PO.create_optimizer(cfg, models[1])
    opts[1].load_state_dict(saved)
    for i in (0, 1):
        steps(i, 3, np.random.RandomState(2))
    for (k, p), q in zip(models[0].named_parameters(),
                         models[1].parameters()):
        assert torch.equal(p, q), k


def test_flax_layouts_match_the_jax_trees():
    """``flax_layouts`` (the shapes the optimizers factor and the trust
    ratio reads, worked out from the port's modules alone) equal the
    JAX init's leaf shapes (``jax.eval_shape``) for the generative model
    with a MoE in the fusion and the classification model with MCAN, the
    MoE and the knowledge branch, and the leaves map 1:1."""
    from test_torch_support import gen_config, gen_inputs, moe
    from vivqa_tpu.models import config as JC
    from vivqa_tpu.models.generative import GenerativeVQAModel as JGen
    from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JCls
    from vivqa_tpu_torch.models import config as PC
    from vivqa_tpu_torch.models.generative import GenerativeVQAModel
    from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel

    def cls_config(mod):
        return mod.VQAModelConfig(
            visual=mod.VisualEncoderConfig(image_size=16, patch_size=8,
                                           hidden_dim=32, num_layers=1,
                                           num_heads=2),
            text=mod.TextEncoderConfig(vocab_size=50, hidden_dim=32,
                                       num_layers=1, num_heads=2,
                                       max_length=8),
            fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                    num_heads=2, num_layers=1),
            moe=mod.MoEModelConfig(use_moe=True, num_experts=2, top_k=1,
                                   expert_hidden_dim=32),
            knowledge=mod.KnowledgeModelConfig(use_knowledge=True,
                                               knowledge_dim=16,
                                               num_retrieved=2),
            num_answers=7)
    key = jax.random.PRNGKey(0)
    px, q, _, dec, _ = gen_inputs()
    gen_shapes = jax.eval_shape(
        JGen(gen_config(JC).replace(moe=moe("fusion", JC))).init,
        {"params": key, "router": key}, px, q, dec)["params"]
    cls_shapes = jax.eval_shape(
        JCls(cls_config(JC)).init, {"params": key, "router": key},
        np.zeros((2, 16, 16, 3), np.float32), np.ones((2, 8), np.int32),
        np.ones((2, 8), np.int32), np.zeros((2, 2, 16), np.float32),
        np.ones((2, 2), np.int32))["params"]
    for model, shapes in (
            (GenerativeVQAModel(gen_config(PC).replace(moe=moe("fusion", PC))),
             gen_shapes),
            (VietnameseVQAModel(cls_config(PC)), cls_shapes)):
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        FJ.check_one_to_one(model, {
            "/".join(k.key for k in path): leaf.shape
            for path, leaf in flat})
