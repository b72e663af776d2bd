"""Parity of the port's transformer building blocks with
vivqa_tpu/models/layers.py, on the CPU (the plain attention path)."""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, assert_close,
                                assert_close_bf16, jax_params,
                                padding_mask, port_with)
from vivqa_tpu.models import layers as J
from vivqa_tpu_torch.models import layers as P

torch.set_num_threads(1)

D, H, L = 32, 2, 8


def _x(shape=(2, L, D), seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _qk_mask(lengths=(8, 5)):
    pm = padding_mask(lengths, L)
    return pm, (pm[:, None, :, None] * pm[:, None, None, :]) != 0


def test_mlp_block():
    x = _x()
    jm = J.MlpBlock(64, dtype=jnp.float32)
    params = jax_params(jm, x)
    port = port_with(P.MlpBlock(D, 64, dtype=torch.float32), params)
    assert_close(port(torch.from_numpy(x)),
                 jm.apply({"params": params}, x), **F32_TOL)


@pytest.mark.parametrize("name", sorted(P.ACTIVATIONS))
def test_activations(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    assert_close(P.ACTIVATIONS[name](torch.from_numpy(x)),
                 J.ACTIVATIONS[name](jnp.asarray(x)), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    x = _x(seed=1) * 3 + 1
    jm = nn.LayerNorm(dtype=J.to_dtype(dtype))
    params = jax_params(jm, x)
    port = port_with(P.LayerNorm(D, P.to_dtype(dtype)), params)
    got = port(torch.from_numpy(x).to(P.to_dtype(dtype)))
    want = jm.apply({"params": params}, jnp.asarray(x, J.to_dtype(dtype)))
    assert got.dtype == P.to_dtype(dtype)
    tol = F32_TOL if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    assert_close(got, want, **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(masked):
    x = _x(seed=2)
    _, mask = _qk_mask()
    jm = nn.MultiHeadDotProductAttention(num_heads=H, dtype=jnp.float32)
    params = jax_params(jm, x, x)
    port = port_with(P.MultiHeadDotProductAttention(D, H,
                                                    dtype=torch.float32),
                     params)
    m = mask if masked else None
    got = port(torch.from_numpy(x), torch.from_numpy(x),
               None if m is None else torch.from_numpy(m))
    want = jm.apply({"params": params}, x, x,
                    mask=None if m is None else jnp.asarray(m))
    assert_close(got, want, **F32_TOL)


def test_cached_cross_attention_no_decode():
    """decode=False with a context of another width and length."""
    x, ctx = _x(seed=3), _x((2, 5, 48), seed=4)
    key_mask = padding_mask((5, 3), 5)
    mask = (np.ones((2, 1, L, 1)) * key_mask[:, None, None, :]) != 0
    jm = J.CachedCrossAttention(num_heads=H, dtype=jnp.float32)
    params = jax_params(jm, x, ctx)
    port = port_with(P.CachedCrossAttention(D, H, kv_dim=48,
                                            dtype=torch.float32), params)
    got = port(torch.from_numpy(x), torch.from_numpy(ctx),
               torch.from_numpy(mask))
    want = jm.apply({"params": params}, x, ctx, mask=jnp.asarray(mask))
    assert_close(got, want, **F32_TOL)


ENCODER_CASES = [
    dict(norm_style="pre", layer_scale_init=0.0, activation="gelu_tanh"),
    dict(norm_style="pre", layer_scale_init=0.1, activation="quick_gelu"),
    dict(norm_style="post", layer_scale_init=0.0, activation="gelu"),
]


@pytest.mark.parametrize("case", ENCODER_CASES, ids=str)
def test_encoder_layer_f32(case):
    """Padded query rows included: they are fully masked."""
    x = _x(seed=5)
    _, mask = _qk_mask()
    jm = J.EncoderLayer(num_heads=H, d_ff=64, dtype=jnp.float32, **case)
    params = jax_params(jm, x, jnp.asarray(mask))
    port = port_with(P.EncoderLayer(D, H, 64, dtype=torch.float32, **case),
                     params)
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    want = jm.apply({"params": params}, x, jnp.asarray(mask))
    assert_close(got, want, **F32_TOL)


def test_encoder_layer_bf16():
    x = _x(seed=6)
    _, mask = _qk_mask()
    jm = J.EncoderLayer(num_heads=H, d_ff=64, dtype=jnp.bfloat16)
    params = jax_params(jm, x, jnp.asarray(mask))
    port = port_with(P.EncoderLayer(D, H, 64, dtype=torch.bfloat16), params)
    got = port(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))
    want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(mask))
    assert got.dtype == torch.bfloat16
    assert_close_bf16(got, want)


def test_cross_attention_layer():
    """MCAN decoder form: unmasked self-attention, key-padded cross."""
    x, ctx = _x((2, 6, D), seed=7), _x(seed=8)
    pm = padding_mask((8, 4), L)
    cross = P.make_attention_mask(torch.ones(2, 6, dtype=torch.int32),
                                  torch.from_numpy(pm))
    jm = J.CrossAttentionLayer(num_heads=H, d_ff=64, dtype=jnp.float32)
    params = jax_params(jm, x, ctx, cross_mask=jnp.asarray(cross.numpy()))
    port = port_with(P.CrossAttentionLayer(D, H, 64, dtype=torch.float32),
                     params)
    got = port(torch.from_numpy(x), torch.from_numpy(ctx), cross_mask=cross)
    want = jm.apply({"params": params}, x, ctx,
                    cross_mask=jnp.asarray(cross.numpy()))
    assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("pooling", ["cls", "mean", "max"])
def test_pool_sequence(pooling):
    x = _x(seed=9)
    pm = padding_mask((8, 3), L)
    assert_close(P.pool_sequence(torch.from_numpy(x), torch.from_numpy(pm),
                                 pooling),
                 J.pool_sequence(jnp.asarray(x), jnp.asarray(pm), pooling),
                 **F32_TOL)


@pytest.mark.parametrize("which", ["both", "query_none", "key_none", "none"])
def test_make_attention_mask(which):
    q = padding_mask((4, 2), 4)
    k = padding_mask((5, 1), 6)
    qm = None if which in ("query_none", "none") else q
    km = None if which in ("key_none", "none") else k
    want = J.make_attention_mask(None if qm is None else jnp.asarray(qm),
                                 None if km is None else jnp.asarray(km))
    got = P.make_attention_mask(None if qm is None else torch.from_numpy(qm),
                                None if km is None else torch.from_numpy(km))
    if want is None:
        assert got is None
        return
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.device_get(want)))
