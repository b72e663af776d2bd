"""The generative model of the port against the JAX package at tiny widths:
``CrossModalFusion``, ``TransformerDecoder`` (teacher forcing, tied and
untied, with and without a decoder padding mask), the MoE positions,
``GenerativeVQAModel.forward``/``encode``, and the cached ``decode_step``
against flax's ``decode=True`` steps. Same weights through
``load_flax_params``, same numpy inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (B, F32_TOL, LA, LQ, V, assert_close,
                                assert_close_bf16, gen_config, gen_inputs,
                                gen_model_pair as model_pair, jax_params,
                                padding_mask, port_with, t)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.decoder import TransformerDecoder as JDecoder
from vivqa_tpu.models.generative import CrossModalFusion as JFusion
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.decoder import TransformerDecoder
from vivqa_tpu_torch.models.generative import (CrossModalFusion,
                                               GenerativeVQAModel,
                                               create_generative_vqa_model)
from vivqa_tpu_torch.models.layers import make_causal_mask

torch.set_num_threads(1)

@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_cross_modal_fusion_matches_jax(masked):
    rs = np.random.RandomState(1)
    vis = rs.standard_normal((B, 16, 32)).astype(np.float32)
    qt = rs.standard_normal((B, LQ, 32)).astype(np.float32)
    qmask = padding_mask([LQ, 3, 1], LQ) if masked else None
    jf = JFusion(gen_config(JC))
    params = jax_params(jf, vis, qt, qmask)
    want = jf.apply({"params": params}, vis, qt, qmask)
    port = port_with(CrossModalFusion(gen_config(PC)), params)
    with torch.inference_mode():
        got = port(t(vis), t(qt), None if qmask is None else t(qmask))
    assert_close(got[0], want[0], **F32_TOL, msg="fused tokens")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert float(got[2]) == 0.0 and got[3] == {}


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("padded", [False, True], ids=["no_pad", "pad"])
def test_decoder_teacher_forcing_matches_jax(padded, tied):
    rs = np.random.RandomState(2)
    _, _, _, dec, dmask = gen_inputs()
    mem = rs.standard_normal((B, 10, 32)).astype(np.float32)
    mem_mask = padding_mask([10, 7, 3], 10)
    dmask = dmask if padded else None
    cfg = dict(tie_embeddings=tied)
    jd = JDecoder(gen_config(JC, **cfg))
    params = jax_params(jd, dec, mem, mem_mask, dmask)
    want = jd.apply({"params": params}, dec, mem, mem_mask, dmask)
    port = port_with(TransformerDecoder(gen_config(PC, **cfg)), params)
    assert hasattr(port, "lm_head") != tied
    with torch.inference_mode():
        got = port(t(dec), t(mem), t(mem_mask),
                   None if dmask is None else t(dmask))
    assert got.dtype == torch.float32 and got.shape == (B, LA, V)
    assert_close(got, want, **F32_TOL, msg="logits")


@pytest.mark.parametrize("position", ["fusion", "decoder", "both"])
def test_moe_positions_match_jax(position):
    """The fusion MoE (with an expert mask) and the decoder MoE: logits
    and the summed aux loss."""
    jm, params, port = model_pair(moe_position=position)
    assert ("moe" in params["fusion"]) == (position != "decoder")
    assert ("decoder_moe" in params["decoder"]) == (position != "fusion")
    px, q, qmask, dec, dmask = gen_inputs()
    em = np.array([1, 0], np.float32) if position != "decoder" else None
    want = jm.apply({"params": params}, px, q, dec, qmask, dmask, em)
    with torch.inference_mode():
        got = port(t(px), t(q), t(dec), t(qmask), t(dmask),
                   None if em is None else t(em))
    assert_close(got["logits"], want["logits"], **F32_TOL, msg="logits")
    assert_close(got["aux_loss"], want["aux_loss"], **F32_TOL, msg="aux")
    assert float(got["aux_loss"]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generative_model_forward_and_encode_match_jax(dtype):
    jm, params, port = model_pair(dtype)
    px, q, qmask, dec, dmask = gen_inputs(3)
    want = jm.apply({"params": params}, px, q, dec, qmask, dmask)
    want_enc = jm.apply({"params": params}, px, q, qmask, method=jm.encode)
    with torch.inference_mode():
        got = port(t(px), t(q), t(dec), t(qmask), t(dmask))
        got_enc = port.encode(t(px), t(q), t(qmask))
    assert got["logits"].dtype == torch.float32
    check = (lambda a, b, msg: assert_close(a, b, **F32_TOL, msg=msg)) \
        if dtype == "float32" else assert_close_bf16
    check(got["logits"], want["logits"], msg="logits")
    check(got_enc["memory"], want_enc["memory"], msg="memory")
    np.testing.assert_array_equal(got_enc["memory_mask"].numpy(),
                                  np.asarray(want_enc["memory_mask"]))


def _flax_decode_steps(jm, params, memory, memory_mask, tokens):
    """Logits of flax's decode=True steps over ``tokens`` (B, T), the
    cache sized for T steps as the JAX generate sizes it."""
    T = tokens.shape[1]
    _, v = jm.apply({"params": params}, jnp.zeros((B, T), jnp.int32), memory,
                    memory_mask, method=jm.decode_step_full,
                    mutable=["cache"])
    cache, out = v["cache"], []
    for i in range(T):
        logits, v = jm.apply({"params": params, "cache": cache},
                             tokens[:, i:i + 1], memory, memory_mask,
                             method=jm.decode_step, mutable=["cache"])
        cache = v["cache"]
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("moe_position", [None, "decoder"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_decode_steps_match_flax(dtype, moe_position):
    """The port's decode_step over its DecodeCache against flax's cached
    steps on the same memory and tokens, and against its own teacher
    forcing."""
    jm, params, port = model_pair(dtype, moe_position)
    px, q, qmask, dec, _ = gen_inputs(4)
    enc = jm.apply({"params": params}, px, q, qmask, method=jm.encode)
    memory = np.asarray(enc["memory"].astype(jnp.float32))
    mmask = np.asarray(enc["memory_mask"])
    want = _flax_decode_steps(jm, params, jnp.asarray(memory).astype(
        enc["memory"].dtype), enc["memory_mask"], jnp.asarray(dec))
    mem = t(memory).to(port.decoder.dtype)
    with torch.inference_mode():
        cache = port.init_cache(mem, t(mmask), LA)
        got = []
        for i in range(LA):
            logits, cache = port.decode_step(t(dec[:, i:i + 1]), cache)
            got.append(logits)
        got = torch.stack(got, dim=1)
        forced = port.decoder(t(dec), mem, t(mmask))
    assert cache.index == LA
    if dtype == "float32":
        assert_close(got, want, **F32_TOL, msg="cached logits")
        assert_close(got, forced, **F32_TOL, msg="cached vs forced")
    else:
        assert_close_bf16(got, want, msg="cached logits")
        assert_close_bf16(got, forced, msg="cached vs forced")


def test_flax_tree_maps_whole_and_only_whole():
    """Every leaf of the generative tree (both encoders, fusion, decoder
    with its MoE) has a parameter; a missing or extra leaf raises."""
    from vivqa_tpu_torch.models.from_jax import (flatten_params,
                                                 load_flax_params)
    _, params, port = model_pair(moe_position="both")
    flat = flatten_params(params)
    for path in ("fusion/v_proj/kernel", "fusion/moe/router/gate/kernel",
                 "decoder/layers_1/cross_attn/value/kernel",
                 "decoder/decoder_moe/experts_w_in", "decoder/ln_final/scale",
                 "visual_encoder/layers_0/mlp/wo/bias",
                 "question_encoder/token_embed/embedding"):
        assert path in flat, path
    del params["decoder"]["ln_final"]["scale"]
    with pytest.raises(ValueError, match="missing.*decoder/ln_final/scale"):
        load_flax_params(port, params)
    _, params, port = model_pair()
    params["decoder"]["cached_key"] = np.zeros((B, LA, 2, 16), np.float32)
    with pytest.raises(ValueError, match="unused.*decoder/cached_key"):
        load_flax_params(port, params)


def test_decode_cache_layout():
    """The cache holds the self-attention K/V of every layer at (B,
    max_len, H, Dh) per layer, zero where no step wrote yet, and the
    projected context K/V."""
    _, _, port = model_pair()
    rs = np.random.RandomState(5)
    mem = t(rs.standard_normal((B, 10, 32)).astype(np.float32))
    with torch.inference_mode():
        cache = port.init_cache(mem, None, 4)
        assert cache.self_kv.shape == (2, 2, B, 4, 2, 16)
        assert cache.cross_kv.shape == (2, 2, B, 10, 2, 16)
        assert cache.cross_mask is None and not cache.self_kv.any()
        k, v = port.decoder.layers[1].cross_attn.project_context(mem)
        assert torch.equal(cache.cross_kv[1, 0], k)
        assert torch.equal(cache.cross_kv[1, 1], v)
        _, cache = port.decode_step(torch.zeros(B, 1, dtype=torch.long),
                                    cache)
        assert cache.self_kv[:, :, :, 0].abs().sum() > 0
        assert not cache.self_kv[:, :, :, 1:].any()


def test_position_limits_raise():
    """JAX clamps a decode position past max_answer_length to the last
    row of its table; the port raises instead (ROADMAP.md Queue C)."""
    _, _, port = model_pair()
    mem = torch.zeros(B, 4, 32)
    with pytest.raises(ValueError, match="max_answer_length"):
        port.init_cache(mem, None, LA + 1)
    with pytest.raises(ValueError, match="max_answer_length"):
        port.decoder(torch.zeros(B, LA + 1, dtype=torch.long), mem)
    cache = port.init_cache(mem, None, 1)
    _, cache = port.decode_step(torch.zeros(B, 1, dtype=torch.long), cache)
    with pytest.raises(ValueError, match="holds 1 steps"):
        port.decode_step(torch.zeros(B, 1, dtype=torch.long), cache)


def test_embedding_scale_rounds_to_compute_dtype():
    """sqrt(512) rounded to bf16 first, as jnp.asarray(d ** 0.5, dtype)."""
    cfg = gen_config(PC, "bfloat16").replace(decoder_dim=512,
                                             decoder_heads=8)
    assert TransformerDecoder(cfg).embed_scale == 22.625
    assert TransformerDecoder(cfg.replace(dtype="float32")).embed_scale \
        == pytest.approx(512 ** 0.5, rel=1e-7)


def test_make_causal_mask_matches_flax():
    import flax.linen as nn
    ids = np.zeros((2, 5), np.int32)
    want = np.asarray(nn.make_causal_mask(ids, dtype=jnp.bool_))
    got = make_causal_mask(torch.zeros(2, 5, dtype=torch.long))
    np.testing.assert_array_equal(got.expand(2, 1, 5, 5).numpy(), want)


def test_training_forward_needs_a_generator():
    """model.train() draws its dropout from the caller's generator; at
    dropout 0 it gives the eval logits."""
    cfg = gen_config(PC)
    port = create_generative_vqa_model(
        cfg.replace(text=cfg.text.replace(dropout=0.0)), device="cpu")
    px, q, qmask, dec, dmask = gen_inputs()
    args = (t(px), t(q), t(dec), t(qmask), t(dmask))
    with torch.no_grad():
        want = port(*args)["logits"]
        port.train()
        with pytest.raises(ValueError, match="Generator"):
            port(*args)
        got = port(*args, generator=torch.Generator().manual_seed(0))
    port.eval()
    assert torch.equal(got["logits"], want)


def test_knowledge_raises():
    """The knowledge model builds (it raised while the RAG path was not
    ported; the name is kept): ``knowledge_proj`` and ``knowledge_ln``
    exist, the memory is K tokens longer with the knowledge arrays and
    unchanged without them."""
    K = 4
    cfg = gen_config(PC).replace(knowledge=PC.KnowledgeModelConfig(
        use_knowledge=True, knowledge_dim=24, num_retrieved=K))
    model = create_generative_vqa_model(cfg, device="cpu")
    assert model.knowledge_proj.weight.shape == (32, 24)
    assert model.knowledge_ln.weight.shape == (32,)
    px, q, qmask, _, _ = gen_inputs()
    know = torch.randn(3, K, 24)
    with torch.no_grad():
        plain = model.encode(t(px), t(q), t(qmask))
        enc = model.encode(t(px), t(q), t(qmask), knowledge_embeddings=know,
                           knowledge_mask=torch.tensor([[1, 1, 1, 1],
                                                        [1, 0, 0, 0],
                                                        [0, 0, 0, 0]]))
    L = plain["memory"].shape[1]
    assert enc["memory"].shape == (3, L + K, 32)
    assert torch.equal(enc["memory"][:, :L], plain["memory"])
    assert enc["memory_mask"][:, L:].tolist() == [[1, 1, 1, 1], [1, 0, 0, 0],
                                                  [0, 0, 0, 0]]
    assert not hasattr(GenerativeVQAModel(gen_config(PC)), "knowledge_proj")


def test_create_generative_model_defaults_to_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_generative_vqa_model(gen_config(PC))
    model = create_generative_vqa_model(gen_config(PC), device="cpu")
    assert not model.training
    assert next(model.parameters()).device.type == "cpu"
