"""Shared helpers of the port's parity tests, and the tests of the weight
bridge itself.

The parity tests make their inputs with numpy from a seed, initialise the
JAX module on the CPU, perturb every param so that biases and LayerNorm
scales are not trivially 0 and 1, copy the tree into the port's module
with ``vivqa_tpu_torch.models.from_jax`` and compare outputs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from vivqa_tpu_torch.models.from_jax import flatten_params, load_flax_params

torch.set_num_threads(1)

# f32 modules agree to float rounding; the tolerance covers the different
# summation orders of XLA's and torch's CPU kernels
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def jax_params(module, *args, seed: int = 0, noise: float = 0.05,
               rngs=None, jit: bool = False, **kwargs):
    """Init ``module`` with JAX (jitted with ``jit``: faster for a whole
    model than op by op), then add seeded normal noise to every leaf."""
    import jax      # here, so that the card's tests import this file without JAX
    key = jax.random.PRNGKey(seed)
    init = jax.jit(module.init) if jit else module.init
    variables = init(rngs or key, *args, **kwargs)
    rs = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + noise * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))


@contextlib.contextmanager
def kept_prng_impl():
    """Restore JAX's global ``jax_default_prng_impl`` on exit. The JAX
    pipelines' ``set_seed`` (``vivqa_tpu/utils/seeding.py``) switches it
    to ``unsafe_rbg``; ``tests/conftest.py`` restores it after each test
    but not after a module-scoped fixture, so without this a fixture that
    runs a JAX pipeline would change which weights
    ``jax.random.PRNGKey(0)`` initialises in the next test file of the
    same process."""
    import jax
    prev = jax.config.jax_default_prng_impl
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", prev)


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


# the generative tests' tiny model: batch, question length, answer
# length, vocab
B, LQ, LA, V = 3, 8, 6, 50


def gen_config(mod, dtype: str = "float32", **overrides):
    """tests/test_decoding.py's tiny config in ``mod``'s config classes."""
    cfg = mod.GenerativeVQAConfig(
        visual=mod.VisualEncoderConfig(image_size=32, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype=dtype),
        text=mod.TextEncoderConfig(vocab_size=V, hidden_dim=32, num_layers=1,
                                   num_heads=2, max_length=LQ, dtype=dtype),
        fusion_dim=32, fusion_layers=1, fusion_heads=2,
        vocab_size=V, decoder_layers=2, decoder_heads=2, decoder_dim=32,
        decoder_ff_dim=64, max_answer_length=LA, dropout=0.0,
        bos_token_id=0, eos_token_id=49, pad_token_id=1, dtype=dtype)
    return cfg.replace(**overrides) if overrides else cfg


def moe(position: str, mod):
    return mod.MoEModelConfig(use_moe=True, num_experts=2, top_k=1,
                              expert_hidden_dim=32, moe_position=position)


def gen_inputs(seed: int = 0):
    rs = np.random.RandomState(seed)
    px = rs.standard_normal((B, 32, 32, 3)).astype(np.float32)
    qmask = padding_mask([LQ, 5, 2], LQ)
    q = (rs.randint(4, V, (B, LQ)) * qmask).astype(np.int32)
    dec = rs.randint(3, V, (B, LA)).astype(np.int32)
    dec[:, 0] = 0                                          # BOS
    dmask = padding_mask([LA, 4, 1], LA)
    return px, q, qmask, dec, dmask


def t(a):
    """numpy -> torch, integers as int64 (token ids, masks)."""
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind == "i" \
        else torch.from_numpy(a)


def gen_model_pair(dtype: str = "float32", moe_position: str | None = None):
    """(JAX GenerativeVQAModel, its perturbed params, the port's model with
    those params) at ``gen_config``."""
    import jax
    from vivqa_tpu.models import config as JC
    from vivqa_tpu.models.generative import GenerativeVQAModel as JModel
    from vivqa_tpu_torch.models import config as PC
    from vivqa_tpu_torch.models.generative import GenerativeVQAModel

    def config(mod):
        cfg = gen_config(mod, dtype)
        return cfg if moe_position is None else cfg.replace(
            moe=moe(moe_position, mod))
    px, q, _, dec, _ = gen_inputs()
    jm = JModel(config(JC))
    key = jax.random.PRNGKey(0)
    params = jax_params(jm, px, q, dec, rngs={"params": key, "router": key})
    return jm, params, port_with(GenerativeVQAModel(config(PC)), params)


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


def small_cls_config(mod, dropout: float = 0.0):
    """The flagship's classification structure (ViT, text encoder, MCAN,
    answer head; no MoE) at width 32, one layer each, 16 px, 8 tokens,
    10 answers, in f32, in ``mod``'s config classes."""
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(image_size=16, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype="float32"),
        text=mod.TextEncoderConfig(vocab_size=50, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dropout=dropout, dtype="float32"),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=dropout),
        head=mod.AnswerHeadConfig(dropout=dropout), num_answers=10,
        dtype="float32")


@contextlib.contextmanager
def forced_bf16_as_f32():
    """The JAX package's forced-bf16 classification modules (MCAN, its
    AttFlat, the answer head) computing in f32; ``as_f32`` does the same
    for a port model after it is built."""
    import jax.numpy as jnp
    from vivqa_tpu.models import heads as JH
    from vivqa_tpu.models.fusion import mcan as JMCAN
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMCAN, "to_dtype", lambda name: jnp.float32)
        for cls in (JMCAN.AttFlat, JH.AnswerHead):
            mp.setattr(cls, "dtype", jnp.float32)
        yield


def as_f32(model: torch.nn.Module) -> torch.nn.Module:
    """Every module of ``model`` built in bf16 set to compute in f32."""
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    return model


def small_cls_params(batch: dict, seed: int = 0):
    """JAX init of ``small_cls_config`` on ``batch`` (under the PRNG
    implementation this restores), each leaf perturbed by seeded noise."""
    import jax
    from vivqa_tpu.models import config as JC
    from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
    jm = JModel(small_cls_config(JC))
    with kept_prng_impl():
        key = jax.random.PRNGKey(seed)
        variables = jax.jit(jm.init)({"params": key, "router": key},
                                     batch["pixel_values"],
                                     batch["input_ids"],
                                     batch["attention_mask"])
    rs = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))


def shape_tree(tree, prefix: str = "") -> dict:
    """{flax path: shape} of a tree of arrays or ``jax.eval_shape``
    structs, for ``check_one_to_one`` without running an init."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(shape_tree(value, path) if isinstance(value, dict)
                   else {path: tuple(value.shape)})
    return out


def grads_against_jax(j_outputs, params, p_outputs, port: torch.nn.Module,
                      seed: int = 0):
    """The gradient of sum_i <out_i, c_i> (seeded normal cotangents c_i)
    with respect to every parameter, from ``jax.grad`` of
    ``j_outputs(params)`` (a list of JAX arrays, jitted once) and from
    autograd of ``p_outputs()`` (the same list from ``port``, which holds
    ``params``). Returns (port's outputs, JAX's outputs, port's gradient,
    JAX's gradient), the gradients as {flax path: f32 array}."""
    import jax
    import jax.numpy as jnp
    from vivqa_tpu_torch.models.from_jax import to_flax
    rs = np.random.RandomState(seed)
    got_outs = p_outputs()
    cots = [rs.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in got_outs]

    def loss(p):
        outs = j_outputs(p)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cots)), outs
    (_, want_outs), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = flatten_params(jax.device_get(want))
    port.zero_grad()
    sum((o.float() * torch.from_numpy(c)).sum()
        for o, c in zip(got_outs, cots)).backward()
    got = to_flax(port, {n: p.grad if p.grad is not None
                         else torch.zeros_like(p)
                         for n, p in port.named_parameters()},
                  {k: v.shape for k, v in want.items()})
    return ([o.detach() for o in got_outs],
            [np.asarray(o, np.float32) for o in want_outs], got, want)


def assert_grads_close(got: dict, want: dict, rtol: float = 1e-5,
                       floor: float = 1e-5):
    """Every leaf to ``rtol`` of its own largest element. A leaf whose
    exact gradient is 0 (an attention key bias: a softmax ignores a
    shift) holds rounding noise only, so no leaf is held tighter than
    ``floor`` of the largest element of all."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        tol = max(rtol * float(np.abs(w).max()), floor * top)
        diff = float(np.abs(got[path] - w).max())
        assert diff <= tol, f"{path}: max |diff| {diff} > {tol}"
