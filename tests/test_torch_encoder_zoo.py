"""Parity of the port's encoder zoo with the JAX package: the ResNet and
Swin visual encoders, DeBERTa's disentangled-attention text encoder, and
the representation zoo (region, multi-resolution and vision-token image
embeddings; the text-embedding factory).

Each module is initialised by JAX (jitted, then seeded noise on every
leaf) and copied into the port. In f32 the outputs are held to 1e-5 and
every gradient leaf of sum <out, c> to 1e-5 of its largest element; the
image representations compute in bf16 whatever the config says
(``to_dtype("bfloat16")`` in the JAX module, ``_DTYPE`` in the port), so
their f32 cases patch both. In bf16 the modules run as built, held by
``assert_close_bf16``. The sizes reach every branch: ResNet at width 32
(32 groups divide every width) with a block of each kind, Swin with
shifted windows and a merge, DeBERTa's log buckets, and an FPN level of
odd size, where flax's "SAME" padding and ``jax.image.resize``'s
half-pixel nearest rule differ from the obvious torch calls.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_support import (F32_TOL, assert_close, assert_close_bf16,
                                assert_grads_close, grads_against_jax,
                                jax_params, padding_mask, port_with,
                                shape_tree)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.encoders import create_visual_encoder as jcreate_visual
from vivqa_tpu.models.encoders import deberta as JD
from vivqa_tpu.models.encoders import representation as JR
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.encoders import create_visual_encoder
from vivqa_tpu_torch.models.encoders import deberta as PD
from vivqa_tpu_torch.models.encoders import representation as PR
from vivqa_tpu_torch.models.from_jax import check_one_to_one, flatten_params
from vivqa_tpu_torch.models.vqa_model import encoder_out_dim

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _check(got, want, dtype, msg=""):
    if dtype == "float32":
        assert_close(got, want, **F32_TOL, msg=msg)
    else:
        assert_close_bf16(got, want, msg=msg)


_PARAMS: dict = {}


def _params(jm, *args):
    """One jitted JAX init per module and input shape, shared by the f32
    and the bf16 case (the params are f32 in both)."""
    key = (repr(jm), tuple(np.shape(a) for a in args))
    if key not in _PARAMS:
        _PARAMS[key] = jax_params(jm, *args, jit=True)
    return _PARAMS[key]


def _run(jm, port, j_args, p_args, dtype, params, grads=False,
         keys=("pooled", "tokens")):
    """Outputs (and with ``grads`` the gradients of sum <out, c>, every
    leaf but the token table: JAX's embedding backward rounds its
    incoming gradient to bf16 even in f32, ROADMAP.md Queue C) of the JAX
    module and its port on the same inputs; asserts them."""
    def j_out(p):
        out = jm.apply({"params": p}, *j_args)
        return [out[k] for k in keys]

    def p_out():
        out = port(*p_args)
        return [out[k] for k in keys]
    if grads:
        got, want, got_g, want_g = grads_against_jax(j_out, params, p_out,
                                                     port)
        for g in (got_g, want_g):
            g.pop("token_embed/embedding", None)
        assert_grads_close(got_g, want_g)
    else:
        with torch.no_grad():
            got = p_out()
        want = jax.jit(j_out)(params)
    for key, g, w in zip(keys, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), key
        assert g.dtype == getattr(torch, dtype), key
        _check(g, w, dtype, key)
    check_one_to_one(port, {k: v.shape
                            for k, v in flatten_params(params).items()})


# -- ResNet and Swin ---------------------------------------------------------
RESNET = dict(backbone="resnet", image_size=32, resnet_width=32,
              resnet_stages=(1, 2))
SWIN = dict(backbone="swin", image_size=16, swin_window=2,
            swin_depths=(2, 2), swin_heads=(2, 4), swin_embed_dim=32,
            output_dim=24, activation="gelu", ln_eps=1e-5)
# (config, dtype, gradients too)
VISUAL_CASES = [
    (RESNET, "float32", True),
    (dict(RESNET, resnet_norm="frozen_bn", output_dim=24), "bfloat16",
     False),
    (SWIN, "float32", True),
    (SWIN, "bfloat16", False),
]


@pytest.mark.parametrize("case,dtype,grads", VISUAL_CASES, ids=str)
def test_zoo_visual_encoder_matches_jax(case, dtype, grads):
    """ResNet: stage 0's block 0 and stage 1's block 0 downsample (the
    width, then the stride), stage 1's block 1 does not; GroupNorm's 32
    groups (f32 statistics, eps 1e-6) or the frozen affine. Swin: the
    4x4 map of stage 0 runs a plain and a shifted block (window 2, shift
    1), the merge halves it, stage 1 shrinks to one window and turns the
    shift off."""
    case = dict(case, dtype=dtype)
    px = _rand((2, case["image_size"], case["image_size"], 3), 0)
    jm = jcreate_visual(JC.VisualEncoderConfig(**case))
    params = _params(jcreate_visual(JC.VisualEncoderConfig(
        **dict(case, dtype="float32"))), px)
    port = port_with(create_visual_encoder(PC.VisualEncoderConfig(**case)),
                     params)
    _run(jm, port, (px,), (torch.from_numpy(px),), dtype, params, grads)
    leaves = flatten_params(params)
    if case["backbone"] == "resnet":
        assert "stage0_block0/downsample_norm/" + (
            "scale" if case.get("resnet_norm") != "frozen_bn"
            else "bias") in leaves
        assert not any(k.startswith("stage1_block1/downsample")
                       for k in leaves)
    else:
        assert leaves["stage0_block1/attn/rel_pos_bias"].shape == (9, 2)
        assert port.stage0_block1.shift == 1
        assert port.stage1_block1.shift == 0


def test_encoder_out_dim_is_the_last_stage():
    """flax infers the towers' widths at the first call; the port computes
    them: ResNet-50 4 * 64 * 2^3 = 2048, Swin-B 128 * 2^3 = 1024, and a
    projection's width where there is one."""
    r50 = PC.VisualEncoderConfig(backbone="resnet")
    swin_b = PC.VisualEncoderConfig(backbone="swin", swin_embed_dim=128,
                                    swin_depths=(2, 2, 18, 2),
                                    swin_heads=(4, 8, 16, 32))
    assert encoder_out_dim(r50) == 2048
    assert encoder_out_dim(swin_b) == 1024
    assert encoder_out_dim(r50.replace(output_dim=96)) == 96
    assert encoder_out_dim(PC.VisualEncoderConfig()) == 768
    for case in (RESNET, SWIN):
        cfg = dict(case, dtype="float32")
        px = np.zeros((1, cfg["image_size"], cfg["image_size"], 3),
                      np.float32)
        jm = jcreate_visual(JC.VisualEncoderConfig(**cfg))
        shapes = jax.eval_shape(lambda: jm.apply(
            jm.init(jax.random.PRNGKey(0), px), px))
        assert shapes["tokens"].shape[-1] == encoder_out_dim(
            PC.VisualEncoderConfig(**cfg))


# -- DeBERTa -----------------------------------------------------------------
# (config, dtype, gradients too)
DEBERTA_CASES = [
    ({}, "float32", True),
    (dict(pos_att_type=("c2p",), norm_rel_ebd=False, pooling="mean",
          output_dim=24), "bfloat16", False),
]


@pytest.mark.parametrize("case,dtype,grads", DEBERTA_CASES, ids=str)
def test_deberta_encoder_matches_jax(case, dtype, grads):
    """At position_buckets 4 and max_relative_positions 16 over 12
    tokens the relative positions past +-2 are log-bucketed; the third
    row is fully padded (a uniform softmax over -1e9)."""
    kw = dict(vocab_size=60, hidden_dim=32, num_layers=2, num_heads=2,
              max_length=12, position_buckets=4, max_relative_positions=16,
              dropout=0.0, **case)
    mask = padding_mask((12, 7, 0), 12)
    ids = (np.random.RandomState(1).randint(3, 60, (3, 12)) * mask).astype(
        np.int32)
    jm = JD.DeBERTaEncoder(JD.DeBERTaConfig(dtype=dtype, **kw))
    params = _params(JD.DeBERTaEncoder(JD.DeBERTaConfig(**kw)), ids, mask)
    port = port_with(PD.DeBERTaEncoder(PD.DeBERTaConfig(dtype=dtype, **kw)),
                     params)
    _run(jm, port, (ids, mask), (torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask)), dtype, params,
         grads)
    rel = PD.build_relative_position(12, 12, 4, 16)
    np.testing.assert_array_equal(rel, JD.build_relative_position(12, 12, 4,
                                                                  16))
    assert np.abs(rel).max() < 11      # log-bucketed beyond +-2


# -- the representation zoo ---------------------------------------------------
@contextlib.contextmanager
def representations_as_f32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "to_dtype", lambda name: jnp.float32)
        mp.setattr(PR, "_DTYPE", torch.float32)
        yield


# (kind, image size): 20 px gives the FPN levels 10, 5 and 3, odd sizes
# where XLA's SAME pads (1, 1) and the nearest upsampling 3 -> 5 and
# 5 -> 10 takes half-pixel centres
REPRESENTATIONS = [("region_based", 32), ("multi_resolution", 20),
                   ("vision_token", 32)]


@pytest.mark.parametrize("kind,size,dtype", [
    (kind, size, dtype) for kind, size in REPRESENTATIONS
    for dtype in ("float32", "bfloat16")
    if (kind, dtype) != ("region_based", "bfloat16")])
def test_image_representation_matches_jax(kind, size, dtype):
    """Library modules (no pipeline trains them): outputs in f32, both
    packages patched, and as built in bf16 (the region embedding's bf16
    conv blocks are the multi-resolution ones')."""
    cfg = dict(resnet_width=8, output_dim=16)
    px = _rand((2, size, size, 3), 0)
    params = _params(JR.create_image_representation(
        kind, JC.VisualEncoderConfig(**cfg)), px)
    patch = representations_as_f32() if dtype == "float32" \
        else contextlib.nullcontext()
    with patch:
        jm = JR.create_image_representation(kind,
                                            JC.VisualEncoderConfig(**cfg))
        port = port_with(PR.create_image_representation(
            kind, PC.VisualEncoderConfig(**cfg)), params)
        _run(jm, port, (px,), (torch.from_numpy(px),), dtype, params)


@pytest.mark.parametrize("size", [5, 6, 7, 10])
def test_same_pads_are_xla_same(size):
    """A stride-2 3x3 "SAME" convolution: (0, 1) on an even size, (1, 1)
    on an odd one, as XLA pads; torch's padding=1 differs on even
    sizes."""
    x = _rand((1, 2, size, size), size)
    w = _rand((3, 2, 3, 3), 1)
    want = jax.lax.conv_general_dilated(x, w, (2, 2), "SAME")
    conv = PR.SameConv(2, 3, 3, 2, bias=False, dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        got = conv(torch.from_numpy(x))
    assert_close(got, want, **F32_TOL)
    assert PR.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))


@pytest.mark.parametrize("src,dst", [(3, 5), (5, 10), (4, 7), (7, 4)])
def test_nearest_exact_is_jax_nearest(src, dst):
    """``jax.image.resize(method="nearest")`` samples at half-pixel
    centres: ``nearest-exact``, which ``nearest`` is not at 3 -> 5."""
    x = _rand((1, 1, src, src), 2)
    want = jax.image.resize(x, (1, 1, dst, dst), method="nearest")
    got = F.interpolate(torch.from_numpy(x), size=(dst, dst),
                        mode="nearest-exact")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if (src, dst) == (3, 5):
        other = F.interpolate(torch.from_numpy(x), size=(dst, dst),
                              mode="nearest")
        assert not np.array_equal(other.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["bert", "roberta", "phobert", "generic",
                                  "unknown", "deberta"])
def test_text_embedding_factory_matches_jax(kind):
    """Each kind builds the JAX factory's module: the BERT family a
    ``TextEncoder`` whose ``type_vocab_size`` the kind sets, "deberta" a
    ``DeBERTaEncoder`` of the text config's widths; the leaves are
    flax's."""
    text = dict(vocab_size=40, hidden_dim=16, num_layers=1, num_heads=2,
                max_length=6, type_vocab_size=3)
    jm = JR.create_text_embedding(kind, JC.TextEncoderConfig(**text))
    port = PR.create_text_embedding(kind, PC.TextEncoderConfig(**text))
    assert type(port).__name__ == type(jm).__name__
    assert port.config.to_dict() == jm.config.to_dict()
    ids = np.ones((1, 6), np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids))
    check_one_to_one(port, shape_tree(shapes["params"]))
    assert set(PR.TEXT_EMBEDDING_KINDS) == set(JR.TEXT_EMBEDDING_KINDS)
