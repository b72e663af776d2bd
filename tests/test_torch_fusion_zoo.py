"""Parity of the port's fusion and MoE zoo with the JAX package: MuTAN,
Q-Former and single-stream fusion, the sparse (capacity-dispatch) and
hierarchical MoE layers, and a ``VietnameseVQAModel`` and a generative
model built on them.

Every JAX fusion computes in bf16 whatever the config says (the forced
``to_dtype("bfloat16")`` of each module and the Q-Former layer's ``dtype``
class attribute; the port's ``_DTYPE``), so the f32 cases patch both
packages to f32 and hold outputs to 1e-5 and every gradient leaf to 1e-5
of its largest element; the bf16 cases run the modules as they are, held
by ``assert_close_bf16``. Discrete decisions are held exactly: the masks
each fusion returns, the assignments the sparse layer drops (the input
of its ``ln_out``, which holds every kept contribution, and the tokens it
drops whole), its ``dropped_token_fraction``, and the hierarchical
layer's group choice.
"""

from __future__ import annotations

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, as_f32, assert_close,
                                assert_close_bf16, assert_grads_close,
                                forced_bf16_as_f32, gen_config,
                                grads_against_jax, jax_params,
                                padding_mask, port_with)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.fusion import create_fusion as jcreate_fusion
from vivqa_tpu.models.fusion import mutan as JMU
from vivqa_tpu.models.fusion import qformer as JQF
from vivqa_tpu.models.fusion import single_stream as JSS
from vivqa_tpu.models.generative import GenerativeVQAModel as JGen
from vivqa_tpu.models.moe import config as JMC
from vivqa_tpu.models.moe.layer import create_moe_layer as jcreate_moe
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.fusion import create_fusion
from vivqa_tpu_torch.models.fusion import mutan as PMU
from vivqa_tpu_torch.models.fusion import qformer as PQF
from vivqa_tpu_torch.models.fusion import single_stream as PSS
from vivqa_tpu_torch.models.from_jax import (check_one_to_one,
                                             flatten_params, flax_paths)
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.moe import config as PMC
from vivqa_tpu_torch.models.moe.layer import (HierarchicalMoE,
                                              SparseMOELayer,
                                              create_moe_layer)
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@contextlib.contextmanager
def fusions_as_f32():
    """The zoo's forced-bf16 fusions computing in f32, in both
    packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JMU, JQF, JSS):
            mp.setattr(mod, "to_dtype", lambda name: jnp.float32)
        mp.setattr(JQF.QFormerLayer, "dtype", jnp.float32)
        for mod in (PMU, PQF, PSS):
            mp.setattr(mod, "_DTYPE", torch.float32)
        yield


# -- the fusions --------------------------------------------------------------
T_MASK = padding_mask((8, 3), 8)
VISUAL = {"pooled": _rand((2, 24), 1), "tokens": _rand((2, 5, 24), 2)}
TEXT = {"pooled": _rand((2, 40), 3), "tokens": _rand((2, 8, 40), 4),
        "mask": T_MASK}


def _fusion_cfg(kind):
    return dict(fusion_type=kind, hidden_dim=32, num_heads=2, num_layers=1,
                mutan_rank=3, num_query_tokens=4)


def _torch_inputs():
    return ({k: torch.from_numpy(v) for k, v in VISUAL.items()},
            {k: torch.from_numpy(v) for k, v in TEXT.items()})


FUSIONS = ["mutan", "qformer", "single_stream"]
KEYS = ("pooled", "tokens")


@pytest.fixture(scope="module", params=FUSIONS)
def fusion_run(request):
    """One JAX init of a fusion (the params are f32 in both dtypes), then
    its f32 run (both packages patched: outputs and the gradient of
    sum <out, c>) and its bf16 run as built."""
    kind = request.param
    cfg = _fusion_cfg(kind)
    params = jax_params(jcreate_fusion(JC.FusionConfig(**cfg)), VISUAL, TEXT,
                        jit=True)
    with fusions_as_f32():
        jm = jcreate_fusion(JC.FusionConfig(**cfg))
        port = port_with(create_fusion(PC.FusionConfig(**cfg), 24, 40),
                         params)
        f32 = grads_against_jax(
            lambda p: [jm.apply({"params": p}, VISUAL, TEXT)[k]
                       for k in KEYS],
            params, lambda: [port(*_torch_inputs())[k] for k in KEYS], port)
        f32_mask = port(*_torch_inputs())["mask"]
    jm = jcreate_fusion(JC.FusionConfig(**cfg))
    port = port_with(create_fusion(PC.FusionConfig(**cfg), 24, 40), params)
    bf16 = (port(*_torch_inputs()),
            jax.jit(lambda p: jm.apply({"params": p}, VISUAL, TEXT))(params))
    return {"kind": kind, "params": params, "port": port, "f32": f32,
            "f32_mask": f32_mask, "bf16": bf16}


def test_fusion_f32_output_and_every_gradient_match_jax(fusion_run):
    """f32 (both packages patched): pooled and tokens to 1e-5, the mask
    exactly (MuTAN's and the Q-Former's all ones over their 2 and 4
    tokens, single-stream's [1; image ones; the question's mask]), and
    every gradient leaf to 1e-5 of its largest element."""
    got, want, got_g, want_g = fusion_run["f32"]
    for key, g, w in zip(KEYS, got, want):
        assert g.dtype == torch.float32
        assert_close(g, w, **F32_TOL, msg=key)
    mask = fusion_run["f32_mask"]
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(fusion_run["bf16"][1]["mask"]))
    assert_grads_close(got_g, want_g)
    if fusion_run["kind"] == "single_stream":
        np.testing.assert_array_equal(
            mask.numpy(),
            np.concatenate([np.ones((2, 6), np.int32), T_MASK], axis=1))


def test_fusion_bf16_matches_jax(fusion_run):
    """As built: every zoo fusion computes in bf16."""
    got, want = fusion_run["bf16"]
    for key in KEYS:
        assert got[key].dtype == torch.bfloat16
        assert_close_bf16(got[key], want[key], msg=key)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))


def test_fusion_leaves_are_flax_leaves(fusion_run):
    """``query_tokens``, ``modality_embed`` and ``cls_token`` keep their
    flax names and shapes; every leaf maps one to one."""
    flat = flatten_params(fusion_run["params"])
    check_one_to_one(fusion_run["port"], {k: v.shape for k, v in flat.items()})
    shapes = {"qformer": {"query_tokens": (1, 4, 32)},
              "single_stream": {"modality_embed": (3, 32),
                                "cls_token": (1, 1, 32)},
              "mutan": {"v_factors/kernel": (32, 96)}}[fusion_run["kind"]]
    for path, shape in shapes.items():
        assert flat[path].shape == shape


# -- the sparse and hierarchical MoE layers -----------------------------------
def _moe_cfg(mod, moe_type, cf=1.25, router="topk", top_k=2):
    return mod.MoEConfig(num_experts=4, input_dim=32,
                         expert=mod.ExpertConfig(hidden_dim=48),
                         router=mod.RouterConfig(router_type=router,
                                                 top_k=top_k,
                                                 capacity_factor=cf),
                         moe_type=moe_type, num_groups=2)


def _moe_pair(moe_type, x, em, tied=False, **kw):
    jm = jcreate_moe(_moe_cfg(JMC, moe_type, **kw))
    params = jax_params(jm, x, em, noise=0.2)
    if tied:        # a zero gate: every expert at the same probability
        params["router"]["gate"]["kernel"] = np.zeros_like(
            params["router"]["gate"]["kernel"])
    port = port_with(create_moe_layer(_moe_cfg(PMC, moe_type, **kw)), params)
    return jm, params, port


def _jax_capture(jm, params, x, em, target):
    """The JAX layer's output and the inputs and outputs of its submodule
    ``target`` (flax's method interceptor), applied eagerly: XLA's jit
    fuses ``1 - kept / (T k)`` into another rounding of the dropped
    fraction than the op-by-op path."""
    seen = {}

    def interceptor(next_fn, args, kwargs, context):
        out = next_fn(*args, **kwargs)
        if context.module.name == target \
                and context.method_name == "__call__":
            seen["in"], seen["out"] = args[0], out
        return out
    with fnn.intercept_methods(interceptor):
        y, aux = jm.apply({"params": params}, x, em)
    return y, aux, seen


def _port_capture(port, x, em, target):
    seen = {}

    def hook(module, args, out):
        seen["in"], seen["out"] = args[0], out
    handle = getattr(port, target).register_forward_hook(hook)
    try:
        y, aux = port(torch.from_numpy(np.array(x)),
                      None if em is None else torch.from_numpy(em))
    finally:
        handle.remove()
    return y, aux, seen


X = jnp.asarray(_rand((2, 6, 32), 5))
MASK = np.asarray([0, 1, 1, 1], np.float32)
SPARSE_CASES = [
    dict(cf=1.25, em=None, tied=False),
    dict(cf=0.5, em=None, tied=False),          # drops some
    dict(cf=0.5, em=None, tied=True),           # ties to the lower index
    dict(cf=0.5, em=MASK, tied=True),           # ties among the unmasked
    dict(cf=0.5, em=MASK, tied=False, router="soft"),
    dict(cf=0.5, em=None, tied=False, router="expert_choice"),
]


@pytest.mark.parametrize("case", SPARSE_CASES, ids=str)
def test_sparse_layer_drops_what_jax_drops(case):
    """f32: the output, aux loss and metrics to 1e-5, and the dispatch
    exactly: the ``ln_out`` input (the residual plus every kept
    contribution) to 1e-5, the tokens whose every assignment was dropped
    (their contribution is exactly 0) equal, and
    ``dropped_token_fraction`` bit for bit. At capacity factor 0.5 each
    expert keeps int(0.5 * 12 * 2 / 4) = 3 of its queue, earlier tokens
    first; a zero gate ties every expert, and the lower index wins."""
    kw = {k: v for k, v in case.items() if k not in ("em", "tied")}
    em = case["em"]
    jm, params, port = _moe_pair("sparse", X, em, case["tied"], **kw)
    jy, jaux, jseen = _jax_capture(jm, params, X, em, "ln_out")
    y, aux, seen = _port_capture(port, X, em, "ln_out")
    assert isinstance(port, SparseMOELayer)
    assert_close(y, jy, **F32_TOL)
    assert_close(seen["in"], jseen["in"], **F32_TOL)
    x = np.array(X)
    got_drop = (seen["in"] - torch.from_numpy(x)).abs().amax(-1) == 0
    want_drop = np.abs(np.asarray(jseen["in"]) - x).max(-1) == 0
    np.testing.assert_array_equal(got_drop.numpy(), want_drop)
    frac = aux["metrics"]["dropped_token_fraction"]
    assert float(frac) == float(jaux["metrics"]["dropped_token_fraction"])
    if case["cf"] < 1:
        assert float(frac) > 0
    if case["tied"]:
        assert want_drop.any()
    assert_close(aux["aux_loss"], jaux["aux_loss"], atol=1e-6, rtol=1e-5)
    for key in jaux["metrics"]:
        assert_close(aux["metrics"][key], jaux["metrics"][key], **F32_TOL,
                     msg=key)


@pytest.mark.parametrize("moe_type", ["sparse", "hierarchical"])
def test_zoo_moe_layer_every_gradient_matches_jax(moe_type):
    """f32: the output and the aux loss through the router: every
    gradient leaf to 1e-5 of its largest element (dropping at capacity
    factor 0.5 for the sparse layer)."""
    jm, params, port = _moe_pair(moe_type, X, MASK, cf=0.5)

    def j_out(p):
        y, aux = jm.apply({"params": p}, X, MASK)
        return [y, aux["aux_loss"]]

    def p_out():
        y, aux = port(torch.from_numpy(np.array(X)), torch.from_numpy(MASK))
        return [y, aux["aux_loss"]]
    got, want, *grads = grads_against_jax(j_out, params, p_out, port)
    assert_close(got[0], want[0], **F32_TOL)
    assert_grads_close(*grads)


@pytest.mark.parametrize("em", [None, MASK], ids=["no_mask", "mask"])
def test_hierarchical_layer_matches_jax(em):
    """f32: output, summed aux losses and the group router's metrics to
    1e-5; the group each token goes to (the top-1 group router's argmax)
    exactly; each group takes its slice of ``expert_mask``, in group
    order (expert 0 is group 0's first)."""
    jm, params, port = _moe_pair("hierarchical", X, em)
    jy, jaux, jseen = _jax_capture(jm, params, X, em, "group_router")
    y, aux, seen = _port_capture(port, X, em, "group_router")
    assert isinstance(port, HierarchicalMoE)
    assert_close(y, jy, **F32_TOL)
    assert_close(aux["aux_loss"], jaux["aux_loss"], atol=1e-6, rtol=1e-5)
    assert sorted(aux["metrics"]) == sorted(jaux["metrics"])
    for key in jaux["metrics"]:
        assert_close(aux["metrics"][key], jaux["metrics"][key], **F32_TOL,
                     msg=key)
    np.testing.assert_array_equal(
        seen["out"].combine_weights.argmax(-1).numpy(),
        np.asarray(jseen["out"].combine_weights).argmax(-1))
    if em is not None:
        _, sub_aux = port.group[0](torch.from_numpy(np.array(X)),
                                   torch.from_numpy(em[:2]))
        assert float(sub_aux["metrics"]["expert_usage"][0]) == 0.0
    assert flax_paths(port)["group.1.experts_w_in"] == "group_1/experts_w_in"
    check_one_to_one(port, {k: v.shape
                            for k, v in flatten_params(params).items()})


@pytest.mark.parametrize("moe_type", ["sparse", "hierarchical"])
def test_zoo_moe_layer_bf16_matches_jax(moe_type):
    """In a bf16 model the layers compute in their input's dtype."""
    xb = jnp.asarray(X, jnp.bfloat16)
    jm, params, port = _moe_pair(moe_type, X, None, cf=0.5)
    y, aux = port(torch.from_numpy(np.array(X)).to(torch.bfloat16))
    jy, jaux = jax.jit(lambda p: jm.apply({"params": p}, xb))(params)
    assert y.dtype == torch.bfloat16
    assert_close_bf16(y, jy)


# -- models built on the zoo --------------------------------------------------
def _cls_config(mod, visual, fusion, moe_type, dtype="float32"):
    vis = {"resnet": dict(backbone="resnet", image_size=32, resnet_width=32,
                          resnet_stages=(1, 1)),
           "swin": dict(backbone="swin", image_size=16, swin_window=2,
                        swin_depths=(1, 1), swin_heads=(2, 4),
                        swin_embed_dim=32)}[visual]
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(dtype=dtype, **vis),
        text=mod.TextEncoderConfig(vocab_size=50, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dropout=0.0, dtype=dtype),
        fusion=mod.FusionConfig(fusion_type=fusion, hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=0.0,
                                num_query_tokens=4, mutan_rank=3),
        moe=mod.MoEModelConfig(use_moe=True, moe_type=moe_type,
                               num_experts=4, top_k=2, expert_hidden_dim=32,
                               capacity_factor=0.5),
        head=mod.AnswerHeadConfig(dropout=0.0), num_answers=10, dtype=dtype)


def _cls_batch(size):
    rs = np.random.RandomState(0)
    mask = padding_mask([8, 5, 2], 8)
    return (rs.standard_normal((3, size, size, 3)).astype(np.float32),
            (rs.randint(4, 50, (3, 8)) * mask).astype(np.int32), mask)


def _torch(args):
    return [torch.from_numpy(a).long() if a.dtype.kind == "i"
            else torch.from_numpy(a) for a in args]


MODELS = [("resnet", "qformer", "sparse"),
          ("swin", "single_stream", "hierarchical")]


@pytest.fixture(scope="module", params=MODELS, ids="-".join)
def cls_pair(request):
    """A zoo classification model's JAX init (jitted, then seeded noise)
    and its f32 logits and aux loss, all forced-bf16 modules of both
    packages in f32 (each module's gradient is held on its own above and
    in test_torch_encoder_zoo.py)."""
    visual, fusion, moe_type = request.param
    args = _cls_batch({"resnet": 32, "swin": 16}[visual])
    with forced_bf16_as_f32(), fusions_as_f32():
        jm = JModel(_cls_config(JC, visual, fusion, moe_type))
        key = jax.random.PRNGKey(0)
        params = jax_params(jm, *args, rngs={"params": key, "router": key},
                            jit=True)
        model = as_f32(port_with(VietnameseVQAModel(
            _cls_config(PC, visual, fusion, moe_type)), params))

        def j_out(p):
            out = jm.apply({"params": p}, *args)
            return [out["logits"], out["aux_loss"]]

        def p_out():
            out = model(*_torch(args))
            return [out["logits"], out["aux_loss"]]
        with torch.no_grad():
            run = (p_out(), jax.jit(j_out)(params))
    return request.param, params, model, run


def test_zoo_model_leaves_are_flax_leaves(cls_pair):
    """Every leaf of the JAX model lands in the port one to one, and the
    widths the port computes for ResNet's and Swin's tokens (flax infers
    them) are the ones the JAX fusion was built on."""
    (visual, *_), params, model, _ = cls_pair
    flat = flatten_params(params)
    check_one_to_one(model, {k: v.shape for k, v in flat.items()})
    in_dim = {"resnet": 4 * 32 * 2, "swin": 32 * 2}[visual]
    proj = [k for k in flat if k in ("fusion/v_proj/kernel",
                                     "fusion/v_embed/kernel")]
    assert proj and all(flat[k].shape[0] == in_dim for k in proj)


def test_zoo_model_f32_logits_match_jax(cls_pair):
    got, want = cls_pair[-1]
    assert_close(got[0], want[0], **F32_TOL)
    assert_close(got[1], want[1], atol=1e-6, rtol=1e-5)


def test_generative_model_on_the_zoo_matches_jax():
    """The generative model with a Swin encoder (16 image tokens, 32 wide
    by ``encoder_out_dim``) and the sparse MoE in its fusion,
    f32: the leaves one to one, teacher-forced logits to 1e-5 and the aux
    loss."""
    from test_torch_support import gen_inputs

    def config(mod):
        return gen_config(mod, visual=mod.VisualEncoderConfig(
            backbone="swin", image_size=32, swin_window=4,
            swin_depths=(1, 1), swin_heads=(2, 4), swin_embed_dim=16,
            dtype="float32"), decoder_layers=1,
            moe=mod.MoEModelConfig(use_moe=True, moe_type="sparse",
                                   num_experts=2, top_k=1,
                                   expert_hidden_dim=32,
                                   capacity_factor=0.5))
    px, q, qmask, dec, dmask = gen_inputs()
    jm = JGen(config(JC))
    key = jax.random.PRNGKey(0)
    params = jax_params(jm, px, q, dec, rngs={"params": key, "router": key},
                        jit=True)
    model = port_with(GenerativeVQAModel(config(PC)), params)
    check_one_to_one(model, {k: v.shape
                             for k, v in flatten_params(params).items()})
    args = (px, q, dec, qmask, dmask)
    with torch.no_grad():
        got = model(*_torch(args))
    want = jax.jit(lambda p: jm.apply({"params": p}, *args))(params)
    assert_close(got["logits"], want["logits"], **F32_TOL)
    assert_close(got["aux_loss"], want["aux_loss"], atol=1e-6, rtol=1e-5)
