"""Parity of the port's MoE zoo with the JAX package: the four routers,
every expert type (the six specialized ones too), ``VQAMoELayer`` in the
ablation study's two compositions, the four basic fusions, the weight
bridge over a whole VQA-MoE model, and that model's logits, loss and
every gradient leaf against ``jax.grad``.

The routers compute in f32 and are held to 1e-5. The experts, the
VQA-MoE layer and the fusions compute in bf16 whatever the config says
(``dtype = jnp.bfloat16`` on each flax class), so they are held with
``assert_close_bf16``. The noisy router's training noise comes from the
forward's torch generator, not from JAX's ``router`` rng, so it is held
to its law, and to JAX on its deterministic path only.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (assert_close, assert_close_bf16,
                                jax_params, padding_mask, port_with)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.fusion import create_fusion as jcreate_fusion
from vivqa_tpu.models.moe import config as JMC
from vivqa_tpu.models.moe import routers as JR
from vivqa_tpu.models.moe.experts import StackedExperts as JStacked
from vivqa_tpu.models.moe.experts import create_expert as jcreate_expert
from vivqa_tpu.models.moe.layer import VQAMoELayer as JVQAMoE
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu.models.vqa_model import moe_config_from_model as jfn
from vivqa_tpu.train import losses as JL
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.fusion import create_fusion
from vivqa_tpu_torch.models.from_jax import (flatten_params, flax_paths,
                                             to_flax)
from vivqa_tpu_torch.models.layers import DropoutRNG
from vivqa_tpu_torch.models.moe import config as PMC
from vivqa_tpu_torch.models.moe import routers as PR
from vivqa_tpu_torch.models.moe.experts import StackedExperts, create_expert
from vivqa_tpu_torch.models.moe.layer import VQAMoELayer, create_moe_layer
from vivqa_tpu_torch.models.vqa_model import (VietnameseVQAModel,
                                              moe_config_from_model)
from vivqa_tpu_torch.train import state as PS

torch.set_num_threads(1)

ROUTER_TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _jax_apply(module, params, *args):
    return module.apply({"params": params}, *args)


# -- routers -----------------------------------------------------------------
def _router_pair(kind: str, D: int = 16, E: int = 4, **extra):
    def cfg(mod):
        return mod.RouterConfig(router_type=kind, top_k=2,
                                z_loss_weight=0.001, **extra)
    x = _rand((2, 6, D), 0)
    jm = JR.create_router(cfg(JMC), E)
    params = jax_params(jm, jnp.asarray(x), None, noise=0.5)
    return jm, params, port_with(PR.create_router(cfg(PMC), E, D), params), x


def _assert_router_outputs(got, want):
    assert_close(got.combine_weights, want.combine_weights, **ROUTER_TOL)
    assert_close(got.router_probs, want.router_probs, **ROUTER_TOL)
    assert_close(got.aux_loss, want.aux_loss, atol=1e-6, rtol=1e-5)
    for key in want.metrics:
        assert_close(got.metrics[key], want.metrics[key], **ROUTER_TOL,
                     msg=key)


@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0, 1.0)], ids=str)
@pytest.mark.parametrize("kind", ["topk", "noisy_topk", "noisy_top_k",
                                  "soft", "expert_choice"])
def test_router_matches_jax(kind, mask):
    """Each router (and the alias ``noisy_top_k``) against JAX in f32, with
    and without an expert mask; the noisy router on its deterministic
    (eval) path, the soft router with its entropy term on."""
    extra = {"entropy_weight": 0.01} if kind == "soft" else {}
    jm, params, port, x = _router_pair(kind, **extra)
    em = None if mask is None else np.asarray(mask, np.float32)
    got = port(torch.from_numpy(x),
               None if em is None else torch.from_numpy(em))
    want = jm.apply({"params": params}, jnp.asarray(x), em)
    _assert_router_outputs(got, want)
    if em is not None:
        assert float(got.metrics["expert_usage"][1]) == 0.0


def test_expert_choice_ties_go_to_the_lower_token():
    """Every token the same: all scores tie, and each expert's one slot
    (capacity int(1.25 * 6 / 4) = 1) goes to token 0, as lax.top_k breaks
    ties; torch.topk promises no order among equal values."""
    jm, params, port, _ = _router_pair("expert_choice")
    x = np.repeat(_rand((2, 1, 16), 5), 6, axis=1)
    got = port(torch.from_numpy(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    _assert_router_outputs(got, want)
    chosen = got.combine_weights.detach().numpy() > 0
    assert chosen[:, 0].all() and not chosen[:, 1:].any()


def test_noisy_router_training_noise_law():
    """In training the noise is N(0, 1) * softplus(w_noise(x)) * noise_std,
    drawn from the forward's generator: over 8,192 tokens the standardised
    difference (noisy - clean) / scale has mean 0 and std 1 within five
    standard errors; the masked expert stays masked; the same seed gives
    the same weights and the global RNG is not drawn from."""
    cfg = PMC.RouterConfig(router_type="noisy_topk", noise_std=0.7)
    router = PR.create_router(cfg, 4, 16)
    torch.manual_seed(0)
    for p in router.parameters():
        torch.nn.init.normal_(p, 0.0, 0.5)
    x = torch.from_numpy(_rand((8, 1024, 16), 1))
    em = torch.tensor([1.0, 1.0, 0.0, 1.0])
    clean = router._logits(x, em)
    rng = DropoutRNG(torch.Generator().manual_seed(3))
    noisy = router.noisy_logits(x, clean, em, rng)
    assert torch.equal(noisy[..., 2], clean[..., 2])       # still -1e9
    keep = [0, 1, 3]
    scale = (torch.nn.functional.softplus(router.w_noise(x)) * 0.7)[..., keep]
    z = ((noisy - clean)[..., keep] / scale).flatten().double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n ** 0.5
    assert abs(float(z.std()) - 1.0) < 5 / (2 * n) ** 0.5
    state = torch.random.get_rng_state()
    runs = [router.train()(x, em, DropoutRNG(torch.Generator().manual_seed(9)))
            for _ in range(2)]
    assert torch.equal(runs[0].combine_weights, runs[1].combine_weights)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert not torch.equal(runs[0].combine_weights,
                           router(x, em).combine_weights)


# -- experts -----------------------------------------------------------------
EXPERT_TYPES = ("feedforward", "glu", "vision", "text", "multimodal",
                "segmentation", "object_detection", "ocr",
                "scene_understanding", "spatial_reasoning", "counting")


@pytest.mark.parametrize("kind", EXPERT_TYPES)
def test_expert_matches_jax(kind):
    """Each expert type on bf16 tokens of width 24 (hidden 32, 2 heads)."""
    def cfg(mod):
        return mod.ExpertConfig(expert_type=kind, hidden_dim=32,
                                num_heads=2, dropout=0.1)
    x = _rand((2, 7, 24), 2)
    jm = jcreate_expert(cfg(JMC), name="expert")
    params = jax_params(jm, jnp.asarray(x, jnp.bfloat16))
    port = port_with(create_expert(cfg(PMC), 24), params)
    got = port(_bf16(x))
    want = _jax_apply(jm, params, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 7, 24)
    assert_close_bf16(got, want, msg=kind)


@pytest.mark.parametrize("glu", [False, True])
def test_stacked_experts_match_jax(glu):
    x = _rand((2, 5, 16), 3)
    jm = JStacked(num_experts=3, hidden_dim=24, glu=glu)
    params = jax_params(jm, jnp.asarray(x))
    port = port_with(StackedExperts(3, 16, 24, glu=glu), params)
    got = port(torch.from_numpy(x))
    want = _jax_apply(jm, params, jnp.asarray(x))
    assert got.shape == (2, 5, 3, 16)
    assert_close_bf16(got, want)


# -- the VQA-MoE layer ---------------------------------------------------------
COMPOSITIONS = {"cli_default": (2, 2, 2, 0), "study": (0, 0, 0, 6)}


def _vqa_moe_cfg(mod, comp, router="noisy_topk"):
    nv, nt, nm, ns = comp
    spec = ("object_detection", "counting", "scene_understanding", "ocr",
            "segmentation", "spatial_reasoning")[:ns]
    return mod.VQAMoEConfig(input_dim=32, num_vision_experts=nv,
                            num_text_experts=nt, num_multimodal_experts=nm,
                            specialized_types=spec, expert_hidden_dim=32,
                            num_heads=2,
                            router=mod.RouterConfig(router_type=router))


@pytest.mark.parametrize("leave_out", [None, 1], ids=["all", "loo_1"])
@pytest.mark.parametrize("comp", list(COMPOSITIONS))
def test_vqa_moe_layer_matches_jax(comp, leave_out):
    """Both compositions, the noisy router on its eval path, with and
    without a leave-one-out mask (the masked expert is still computed and
    gets weight 0)."""
    x = _rand((2, 6, 32), 4)
    em = None
    if leave_out is not None:
        em = np.ones(6, np.float32)
        em[leave_out] = 0.0
    jm = JVQAMoE(_vqa_moe_cfg(JMC, COMPOSITIONS[comp]))
    params = jax_params(jm, jnp.asarray(x, jnp.bfloat16), em)
    port = port_with(VQAMoELayer(_vqa_moe_cfg(PMC, COMPOSITIONS[comp])),
                     params)
    y, aux = port(_bf16(x), None if em is None else torch.from_numpy(em))
    jy, jaux = _jax_apply(jm, params, jnp.asarray(x, jnp.bfloat16), em)
    assert y.dtype == torch.bfloat16
    assert_close_bf16(y, jy)
    assert_close(aux["aux_loss"], jaux["aux_loss"], atol=1e-6, rtol=1e-5)
    for key in jaux["metrics"]:
        assert_close(aux["metrics"][key], jaux["metrics"][key], atol=1e-5,
                     rtol=1e-5, msg=key)
    if em is not None:
        assert float(aux["metrics"]["expert_usage"][leave_out]) == 0.0


def test_moe_config_from_model_vqa_branch():
    """The generic "topk" becomes the VQA-MoE's noisy default, a swap
    stays; the specialized experts come in the study's fixed order."""
    for router in ("topk", "soft"):
        def cfg(mod):
            return mod.VQAModelConfig(moe=mod.MoEModelConfig(
                use_moe=True, moe_type="vqa", router_type=router,
                num_vision_experts=0, num_text_experts=1,
                num_multimodal_experts=0, num_specialized_experts=4))
        got = moe_config_from_model(cfg(PC), 64)
        want = jfn(cfg(JC), 64)
        assert got.to_dict() == want.to_dict()
        assert got.router.router_type == (
            "noisy_topk" if router == "topk" else router)
    assert isinstance(create_moe_layer(got), VQAMoELayer)


# -- the basic fusions -------------------------------------------------------
@pytest.mark.parametrize("kind", ["concat", "add", "bilinear",
                                  "cross_attention"])
def test_basic_fusion_matches_jax(kind):
    cfg = dict(fusion_type=kind, hidden_dim=32, num_heads=2, num_layers=2)
    t_mask = padding_mask((8, 3), 8)
    visual = {"pooled": _rand((2, 24), 5), "tokens": _rand((2, 5, 24), 6)}
    text = {"pooled": _rand((2, 40), 7), "tokens": _rand((2, 8, 40), 8),
            "mask": t_mask}
    jm = jcreate_fusion(JC.FusionConfig(**cfg))
    params = jax_params(jm, visual, text)
    port = port_with(create_fusion(PC.FusionConfig(**cfg), 24, 40), params)
    got = port({k: torch.from_numpy(v) for k, v in visual.items()},
               {k: torch.from_numpy(v) for k, v in text.items()})
    want = _jax_apply(jm, params, visual, text)
    for key in ("pooled", "tokens"):
        assert got[key].dtype == torch.bfloat16
        assert_close_bf16(got[key], want[key], msg=key)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))


# -- the VQA-MoE classification model ----------------------------------------
def _model_config(mod, comp, router="soft", dtype="bfloat16"):
    """The study's model structure at width 32, one layer each, 16 px,
    every dropout the config reaches at 0, cross-attention fusion."""
    nv, nt, nm, ns = COMPOSITIONS[comp]
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(image_size=16, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype=dtype),
        text=mod.TextEncoderConfig(vocab_size=50, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dropout=0.0, dtype=dtype),
        fusion=mod.FusionConfig(hidden_dim=32, num_heads=2, num_layers=1,
                                dropout=0.0),
        moe=mod.MoEModelConfig(use_moe=True, moe_type="vqa",
                               router_type=router, num_vision_experts=nv,
                               num_text_experts=nt,
                               num_multimodal_experts=nm,
                               num_specialized_experts=ns,
                               expert_hidden_dim=32),
        head=mod.AnswerHeadConfig(dropout=0.0), num_answers=10, dtype=dtype)


def _batch(B=3, seed=0):
    rs = np.random.RandomState(seed)
    mask = padding_mask([8, 5, 2][:B], 8)
    return {"pixel_values": rs.standard_normal((B, 16, 16, 3)).astype(
                np.float32),
            "input_ids": (rs.randint(4, 50, (B, 8)) * mask).astype(np.int32),
            "attention_mask": mask,
            "labels": rs.randint(0, 10, B).astype(np.int32)}


def _torch_batch(b):
    return {n: torch.from_numpy(a).long() if a.dtype.kind == "i"
            else torch.from_numpy(a) for n, a in b.items()}


def _inputs(b):
    return [b[k] for k in ("pixel_values", "input_ids", "attention_mask")]


def _init(jm, b):
    """Jitted init, then seeded noise on every leaf."""
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)({"params": key, "router": key}, *_inputs(b))
    rs = np.random.RandomState(1)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))


@pytest.fixture(scope="module")
def study_params():
    """The study composition's params (the compute dtype does not change
    them), shared by the bf16 and the f32 tests."""
    return _init(JModel(_model_config(JC, "study")), _batch())


@pytest.fixture(scope="module", params=list(COMPOSITIONS))
def model_pair(request, study_params):
    """A composition's JAX model, its params and its bf16 logits."""
    comp = request.param
    b = _batch()
    jm = JModel(_model_config(JC, comp))
    params = study_params if comp == "study" else _init(jm, b)
    logits = jax.jit(lambda p, *a: jm.apply({"params": p}, *a)["logits"])(
        params, *_inputs(b))
    return comp, params, np.asarray(logits, np.float32)


def test_from_jax_carries_the_whole_vqa_moe_tree(model_pair):
    """Every leaf of the JAX VQA-MoE model (experts under
    ``moe/experts/...``, the Conv1d kernels, the query slots) lands in the
    port, none is missing or left over, and ``to_flax`` gives it back."""
    comp, params, _ = model_pair
    model = port_with(VietnameseVQAModel(_model_config(PC, comp)), params)
    flat = flatten_params(params)
    paths = set(flax_paths(model).values())
    assert paths == set(flat)
    prefix = "moe/experts/" + ("specialized_4_segmentation/boundary_conv1"
                               if comp == "study" else "multimodal_1")
    assert any(p.startswith(prefix) for p in paths)
    back = to_flax(model, dict(model.named_parameters()),
                   {k: v.shape for k, v in flat.items()})
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_vqa_moe_model_logits_match_jax(model_pair):
    """The model as it runs, bf16 from the fusion on. flax's attention
    takes its softmax in bf16 where the port's takes it in f32, and the
    study's OCR expert stacks four attention stages on its slots, so the
    logits agree to bf16 noise only: max 6% of the largest, mean 4% of the
    mean. The f32 test below holds the same arithmetic to 1e-4."""
    comp, params, want = model_pair
    model = port_with(VietnameseVQAModel(_model_config(PC, comp)), params)
    with torch.no_grad():
        got = model(*_inputs(_torch_batch(_batch())))["logits"]
    assert_close_bf16(got, want, max_rel=0.06, mean_rel=0.04, msg=comp)


def _jax_loss(params, batch, apply_fn):
    out = apply_fn({"params": params}, *_inputs(batch), deterministic=True)
    return JL.cross_entropy_loss(out["logits"], batch["labels"]) \
        + 0.01 * out["aux_loss"], out["logits"]


@contextlib.contextmanager
def _everything_f32():
    """Both packages' forced-bf16 modules (the fusion, the experts, the
    answer head's hidden layer) computing in f32, so that the model's
    arithmetic can be held to f32 rounding."""
    from vivqa_tpu.models import heads as JH
    from vivqa_tpu.models.fusion import basic as JB
    from vivqa_tpu.models.moe import experts as JE
    from vivqa_tpu.models.moe import specialized as JS
    from vivqa_tpu_torch.models.fusion import basic as PB
    from vivqa_tpu_torch.models.moe import experts as PE
    from vivqa_tpu_torch.models.moe import specialized as PSP
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "to_dtype", lambda name: jnp.float32)
        for cls in (JH.AnswerHead, JE.StackedExperts, JE.FeedForwardExpert,
                    JE.GatedLinearExpert, JE.VisionExpert, JE.TextExpert,
                    JE.MultimodalExpert, JS._SpecializedBase):
            mp.setattr(cls, "dtype", jnp.float32)
        for mod in (PB, PE, PSP):
            mp.setattr(mod, "_DTYPE", torch.float32)
        yield


@pytest.fixture(scope="module")
def f32_run(study_params):
    """The study composition with the soft router, everything in f32:
    JAX's loss, logits and gradient, the port's loss, logits and
    gradient (dropout 0; eval mode with autograd on is JAX's
    ``deterministic=True``)."""
    b = _batch()
    with _everything_f32():
        jm = JModel(_model_config(JC, "study", dtype="float32"))
        params = study_params
        jb = {n: jnp.asarray(a) for n, a in b.items()}
        (want_loss, want_logits), want_grads = jax.jit(
            jax.value_and_grad(_jax_loss, has_aux=True),
            static_argnums=(2,))(params, jb, jm.apply)
        model = port_with(VietnameseVQAModel(
            _model_config(PC, "study", dtype="float32")), params)
        for m in model.modules():
            if getattr(m, "dtype", None) == torch.bfloat16:
                m.dtype = torch.float32
        out = model(*_inputs(_torch_batch(b)))
        loss = PS.classification_loss_fn()(model, _torch_batch(b), None)[0]
        loss.backward()
    want = flatten_params(jax.device_get(want_grads))
    got = to_flax(model, {n: p.grad if p.grad is not None
                          else torch.zeros_like(p)
                          for n, p in model.named_parameters()},
                  {k: v.shape for k, v in want.items()})
    return {"logits": (out["logits"], want_logits),
            "loss": (loss, want_loss), "grads": (got, want)}


def test_vqa_moe_model_f32_logits_and_loss_match_jax(f32_run):
    got, want = f32_run["logits"]
    assert got.dtype == torch.float32
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert_close(*f32_run["loss"], atol=1e-5, rtol=1e-5)


def test_vqa_moe_model_every_gradient_matches_jax(f32_run):
    """Every leaf of the gradient of CE + 0.01 aux in f32, to 1e-3 of the
    model's largest gradient element: the summation orders differ, and
    the leaves whose exact gradient is 0 (attention key biases: a softmax
    ignores a shift) hold rounding noise only. JAX's embedding backward
    rounds its incoming gradient to bf16 even in an f32 model, so the
    token table agrees to 2**-7 of its largest element."""
    got, want = f32_run["grads"]
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.abs(np.asarray(w)).max() for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        atol = floor + (2 ** -7 * np.abs(w).max()
                        if path.endswith("/embedding") else 0.0)
        np.testing.assert_allclose(got[path], w, rtol=1e-3, atol=atol,
                                   err_msg=path)
