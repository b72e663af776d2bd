"""Parity of the port's ViT and text encoders with the JAX package."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, assert_close,
                                assert_close_bf16, jax_params,
                                padding_mask, port_with, shape_tree)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.encoders import create_text_encoder as j_text
from vivqa_tpu.models.encoders import create_visual_encoder as j_visual
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.encoders import (create_text_encoder,
                                             create_visual_encoder)
from vivqa_tpu_torch.models.from_jax import check_one_to_one

torch.set_num_threads(1)


def _check(got, want, dtype, key):
    if dtype == "float32":
        assert_close(got, want, **F32_TOL, msg=key)
    else:
        assert_close_bf16(got, want, msg=key)


VIT_CASES = [
    dict(vit_style="clip", dtype="float32"),
    dict(vit_style="vit", dtype="float32", output_dim=24,
         layer_scale_init=0.1),
    dict(vit_style="clip", dtype="bfloat16"),
]


@pytest.mark.parametrize("case", VIT_CASES, ids=str)
def test_vit_encoder(case):
    kw = dict(backbone="clip", image_size=32, patch_size=8, hidden_dim=32,
              num_layers=2, num_heads=2, **case)
    px = np.random.RandomState(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = j_visual(JC.VisualEncoderConfig(**kw))
    params = jax_params(jm, px)
    port = port_with(create_visual_encoder(PC.VisualEncoderConfig(**kw)),
                     params)
    got = port(torch.from_numpy(px))
    want = jm.apply({"params": params}, px)
    for key in ("pooled", "tokens"):
        assert got[key].shape == want[key].shape
        _check(got[key], want[key], case["dtype"], key)


TEXT_CASES = [
    dict(norm_style="pre", pooling="cls", dtype="float32"),
    dict(norm_style="post", pooling="mean", dtype="float32",
         type_vocab_size=2, output_dim=24, activation="gelu"),
    dict(norm_style="pre", pooling="max", dtype="bfloat16"),
]


@pytest.mark.parametrize("case", TEXT_CASES, ids=str)
def test_text_encoder(case):
    """Real padding: the padded query rows are fully masked."""
    kw = dict(vocab_size=100, hidden_dim=32, num_layers=2, num_heads=2,
              max_length=8, **case)
    rs = np.random.RandomState(1)
    mask = padding_mask((8, 5, 1), 8)
    ids = (rs.randint(4, 100, (3, 8)) * mask).astype(np.int32)
    jm = j_text(JC.TextEncoderConfig(**kw))
    params = jax_params(jm, ids, mask)
    port = port_with(create_text_encoder(PC.TextEncoderConfig(**kw)), params)
    got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    want = jm.apply({"params": params}, ids, mask)
    for key in ("pooled", "tokens"):
        _check(got[key], want[key], case["dtype"], key)
    np.testing.assert_array_equal(got["mask"].numpy(), mask)


@pytest.mark.parametrize("backbone", ["resnet", "swin"])
def test_unported_visual_backbones_raise(backbone):
    """ResNet and Swin, which raised until the encoder zoo was ported
    (tests/test_torch_encoder_zoo.py holds their numerics), build through
    the factory with the JAX encoder's leaves and run on the CPU to the
    JAX encoder's output shapes."""
    kw = dict(backbone=backbone, image_size=32, resnet_width=32,
              resnet_stages=(1, 1), swin_window=4, swin_depths=(2, 2),
              swin_heads=(2, 4), swin_embed_dim=16, dtype="float32")
    px = np.zeros((1, 32, 32, 3), np.float32)
    jm = j_visual(JC.VisualEncoderConfig(**kw))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), px))
    want = jax.eval_shape(lambda v: jm.apply(v, px), shapes)
    port = create_visual_encoder(PC.VisualEncoderConfig(**kw))
    assert type(port).__name__ == type(jm).__name__
    check_one_to_one(port, shape_tree(shapes["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(px))
    for key in ("pooled", "tokens"):
        assert tuple(got[key].shape) == want[key].shape, key


def test_unknown_backbones_raise():
    with pytest.raises(ValueError):
        create_visual_encoder(PC.VisualEncoderConfig(backbone="nope"))
    with pytest.raises(ValueError):
        create_text_encoder(PC.TextEncoderConfig(backbone="nope"))
