"""Shared helpers of the port's parity tests, and the tests of the weight
bridge itself.

The parity tests make their inputs with numpy from a seed, initialise the
JAX module on the CPU, perturb every param so that biases and LayerNorm
scales are not trivially 0 and 1, copy the tree into the port's module
with ``vivqa_tpu_torch.models.from_jax`` and compare outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vivqa_tpu_torch.models.from_jax import flatten_params, load_flax_params

torch.set_num_threads(1)

# f32 modules agree to float rounding; the tolerance covers the different
# summation orders of XLA's and torch's CPU kernels
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def jax_params(module, *args, seed: int = 0, noise: float = 0.05,
               rngs=None, **kwargs):
    """Init ``module`` with JAX, then add seeded normal noise to every leaf."""
    import jax      # here, so that the card's tests import this file without JAX
    key = jax.random.PRNGKey(seed)
    variables = module.init(rngs or key, *args, **kwargs)
    rs = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + noise * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))


def port_with(module: torch.nn.Module, params) -> torch.nn.Module:
    return load_flax_params(module, params).eval()


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(port_out, jax_out, atol: float, rtol: float, msg=""):
    np.testing.assert_allclose(to_np(port_out), to_np(jax_out), atol=atol,
                               rtol=rtol, err_msg=msg)


def assert_close_bf16(port_out, jax_out, max_rel: float = 0.04,
                      mean_rel: float = 0.02, msg=""):
    """For modules that compute in bf16 (8 significant bits, a relative
    ulp of 2**-7): the two frameworks round at different points, and the
    differences compound over layers and scale with the size of the
    residual stream, not of each element. So the largest difference is
    held to ``max_rel`` of the largest value and the mean difference to
    ``mean_rel`` of the mean value; a fault of layout, masking or
    numerics shows as differences of the order of the values themselves.
    """
    got, want = to_np(port_out), to_np(jax_out)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    diff = np.abs(got - want)
    assert diff.max() <= max_rel * np.abs(want).max(), (
        f"{msg}: max diff {diff.max()} > {max_rel} * {np.abs(want).max()}")
    assert diff.mean() <= mean_rel * np.abs(want).mean(), (
        f"{msg}: mean diff {diff.mean()} > {mean_rel} * "
        f"{np.abs(want).mean()}")


def padding_mask(lengths, L: int) -> np.ndarray:
    return (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)


def test_flatten_params_paths():
    tree = {"a": {"b": {"kernel": np.zeros((2, 3))}}, "c": np.ones(4)}
    flat = flatten_params(tree)
    assert sorted(flat) == ["a/b/kernel", "c"]


def _mlp_pair():
    import jax.numpy as jnp
    from vivqa_tpu.models.layers import MlpBlock as JMlp
    from vivqa_tpu_torch.models.layers import MlpBlock
    x = np.zeros((1, 2, 8), np.float32)
    params = jax_params(JMlp(16, dtype=jnp.float32), x)
    return params, MlpBlock(8, 16, dtype=torch.float32)


def test_from_jax_raises_on_missing_leaf():
    params, port = _mlp_pair()
    del params["wo"]["bias"]
    with pytest.raises(ValueError, match="missing.*wo/bias"):
        load_flax_params(port, params)


def test_from_jax_raises_on_unused_leaf():
    params, port = _mlp_pair()
    params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unused.*extra/kernel"):
        load_flax_params(port, params)


def test_from_jax_raises_on_shape_mismatch():
    params, port = _mlp_pair()
    params["wi"]["kernel"] = np.zeros((8, 17), np.float32)
    with pytest.raises(ValueError):
        load_flax_params(port, params)


def test_from_jax_layouts():
    """DenseGeneral (D, H, Dh) -> (H*Dh, D), out (H, Dh, D) -> (D, H*Dh),
    Conv HWIO -> OIHW, LayerNorm scale -> weight."""
    from vivqa_tpu.models.config import VisualEncoderConfig as JCfg
    from vivqa_tpu.models.encoders.vit import ViTEncoder as JViT
    from vivqa_tpu_torch.models.config import VisualEncoderConfig
    from vivqa_tpu_torch.models.encoders.vit import ViTEncoder
    cfg = VisualEncoderConfig(image_size=16, patch_size=8, hidden_dim=32,
                              num_layers=1, num_heads=2, dtype="float32")
    params = jax_params(JViT(JCfg(**cfg.to_dict())),
                        np.zeros((1, 16, 16, 3), np.float32))
    port = port_with(ViTEncoder(cfg), params)
    attn = params["layers_0"]["self_attn"]
    q = attn["query"]["kernel"]                          # (D, H, Dh)
    np.testing.assert_array_equal(
        port.layers[0].self_attn.query.weight.detach().numpy(),
        q.reshape(32, 32).T)
    np.testing.assert_array_equal(
        port.layers[0].self_attn.out.weight.detach().numpy(),
        attn["out"]["kernel"].reshape(32, 32).T)
    np.testing.assert_array_equal(
        port.patch_embed.weight.detach().numpy(),
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        port.layers[0].ln1.weight.detach().numpy(),
        params["layers_0"]["ln1"]["scale"])
