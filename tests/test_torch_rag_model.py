"""Both model families with knowledge (RAG) against the JAX package, on the
CPU, on bridged weights.

Classification: ``VietnameseVQAModel``'s ``KnowledgeAttention`` (the
fused vector as one query over K retrieved contexts under the knowledge
mask; a sample with fewer than K hits has padding, one with none a fully
masked row) in bf16 (``assert_close_bf16``); with both packages'
forced-bf16 modules (MCAN, the answer head's hidden layer,
``KnowledgeAttention``) patched to f32, the logits to 1e-4, the loss to
1e-5 and every gradient leaf to 1e-3 of the largest; four AdamW steps
against the JAX train step through each package's pipeline loss.

Generative: ``GenerativeVQAModel``'s memory grows by the K projected
contexts (shapes, mask, values), the teacher-forced logits and every
gradient leaf in f32, the cache sized from that memory, and greedy and
beam generates token-identical to JAX's with the knowledge arrays.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, LA, assert_close,
                                assert_close_bf16, gen_config, gen_inputs,
                                padding_mask, port_with, t)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models import decoding as jdec
from vivqa_tpu.models import heads as JH
from vivqa_tpu.models import vqa_model as JVM
from vivqa_tpu.models.fusion import mcan as JMCAN
from vivqa_tpu.models.generative import GenerativeVQAModel as JGenModel
from vivqa_tpu.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig as JGenCfg,
    GenerativeTrainingPipeline as JGenPipeline)
from vivqa_tpu.pipelines.training_pipeline import (
    TrainingPipeline as JTrainPipeline,
    TrainingPipelineConfig as JTrainCfg)
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu.train import state as JS
from vivqa_tpu.data.dataset import IGNORE_INDEX
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models import decoding as pdec
from vivqa_tpu_torch.models.from_jax import flatten_params, to_flax
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.train import optimizers as PO
from vivqa_tpu_torch.train import state as PS

torch.set_num_threads(1)

K, DK = 5, 24
# samples with K, 3, 1 and no retrieved documents
KNOWLEDGE_MASK = padding_mask([5, 3, 1, 0], K)


def _knowledge(B: int, seed: int = 9):
    rs = np.random.RandomState(seed)
    return {"knowledge_embeddings":
                rs.standard_normal((B, K, DK)).astype(np.float32),
            "knowledge_mask": KNOWLEDGE_MASK[:B]}


def _torch(b: dict) -> dict:
    return {n: t(a) for n, a in b.items()}


def _jnp(b: dict) -> dict:
    return {n: jnp.asarray(a) for n, a in b.items()}


# -- classification ---------------------------------------------------------
def _cls_config(mod, dtype="float32"):
    """The flagship's structure (MCAN) at width 32, one layer each, 16 px,
    every dropout at 0, knowledge of K contexts of width DK."""
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(image_size=16, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype=dtype),
        text=mod.TextEncoderConfig(vocab_size=50, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dropout=0.0, dtype=dtype),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=0.0),
        knowledge=mod.KnowledgeModelConfig(use_knowledge=True,
                                           knowledge_dim=DK,
                                           num_retrieved=K),
        head=mod.AnswerHeadConfig(dropout=0.0), num_answers=10, dtype=dtype)


def _cls_batch(seed=0):
    rs = np.random.RandomState(seed)
    mask = padding_mask([8, 5, 2, 7], 8)
    return {"pixel_values": rs.standard_normal((4, 16, 16, 3)).astype(
                np.float32),
            "input_ids": (rs.randint(4, 50, (4, 8)) * mask).astype(np.int32),
            "attention_mask": mask,
            "labels": rs.randint(0, 10, 4).astype(np.int32),
            **_knowledge(4, seed + 9)}


@contextlib.contextmanager
def _forced_bf16_as_f32():
    """Both packages' forced-bf16 modules computing in f32: on the JAX
    side MCAN, AttFlat, the answer head and KnowledgeAttention by their
    dtype; on the port's, every module built in bf16 is set to f32 after
    it is built (``_as_f32``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMCAN, "to_dtype", lambda name: jnp.float32)
        for cls in (JMCAN.AttFlat, JH.AnswerHead, JVM.KnowledgeAttention):
            mp.setattr(cls, "dtype", jnp.float32)
        yield


def _as_f32(model):
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    return model


def _jax_cls_loss():
    """The JAX pipeline's own loss (knowledge from the batch when there);
    every dropout is 0, so its training forward is the eval one."""
    return JTrainPipeline(JTrainCfg())._loss_fn()


@pytest.fixture(scope="module")
def cls_params():
    b = _cls_batch()
    jm = JVM.VietnameseVQAModel(_cls_config(JC))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(
        {"params": key, "router": key}, b["pixel_values"], b["input_ids"],
        b["attention_mask"], b["knowledge_embeddings"], b["knowledge_mask"])
    rs = np.random.RandomState(1)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))


def _cls_port(params, dtype="float32"):
    return port_with(VietnameseVQAModel(_cls_config(PC, dtype)), params)


def test_classification_knowledge_logits_bf16_match_jax(cls_params):
    """The bf16 model (the flagship's dtype) with the knowledge arrays;
    without them both packages skip the branch and agree again; the
    bridge maps every knowledge leaf both ways."""
    b = _cls_batch(seed=2)
    jm = JVM.VietnameseVQAModel(_cls_config(JC, "bfloat16"))
    port = _cls_port(cls_params, "bfloat16")
    for know in (True, False):
        extra = {k: b[k] for k in PS.KNOWLEDGE_KEYS} if know else {}
        want = jm.apply({"params": cls_params}, b["pixel_values"],
                        b["input_ids"], b["attention_mask"], **extra)
        with torch.no_grad():
            got = port(t(b["pixel_values"]), t(b["input_ids"]),
                       t(b["attention_mask"]), **_torch(extra))
        assert_close_bf16(got["logits"], want["logits"], msg=str(know))
        assert_close_bf16(got["features"], want["features"], msg=str(know))
    names = [n for n, _ in port.named_parameters() if "knowledge" in n]
    flat = flatten_params(cls_params)
    back = to_flax(port, dict(port.named_parameters()),
                   {k: v.shape for k, v in flat.items()})
    assert sorted(back) == sorted(flat) and len(names) == 10
    for path in back:
        if path.startswith("knowledge_attn/"):
            np.testing.assert_array_equal(back[path], flat[path])


@pytest.fixture(scope="module")
def cls_f32(cls_params):
    """In f32 (forced-bf16 modules patched in both packages): JAX's
    logits, loss and gradient of its pipeline's loss, the port's through
    ``classification_loss_fn``."""
    b = _cls_batch()
    with _forced_bf16_as_f32():
        jm = JVM.VietnameseVQAModel(_cls_config(JC))
        want_logits = jax.jit(jm.apply)(
            {"params": cls_params}, b["pixel_values"], b["input_ids"],
            b["attention_mask"], b["knowledge_embeddings"],
            b["knowledge_mask"])["logits"]
        (want_loss, _), want_grads = jax.jit(
            jax.value_and_grad(_jax_cls_loss(), has_aux=True),
            static_argnums=(3,))(cls_params, _jnp(b), jax.random.PRNGKey(0),
                                 jm.apply)
    model = _as_f32(_cls_port(cls_params)).train()
    loss, _ = PS.classification_loss_fn()(model, _torch(b),
                                          torch.Generator().manual_seed(0))
    loss.backward()
    with torch.no_grad():
        logits = model.eval()(t(b["pixel_values"]), t(b["input_ids"]),
                              t(b["attention_mask"]),
                              **_torch({k: b[k] for k in
                                        PS.KNOWLEDGE_KEYS}))["logits"]
    want = flatten_params(jax.device_get(want_grads))
    got = to_flax(model, {n: p.grad if p.grad is not None
                          else torch.zeros_like(p)
                          for n, p in model.named_parameters()},
                  {k: v.shape for k, v in want.items()})
    return {"logits": (logits, want_logits), "loss": (loss, want_loss),
            "grads": (got, want)}


def test_classification_knowledge_f32_logits_and_loss_match_jax(cls_f32):
    got, want = cls_f32["logits"]
    assert got.dtype == torch.float32
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert_close(*cls_f32["loss"], **F32_TOL)


def test_classification_knowledge_every_gradient_matches_jax(cls_f32):
    """Every leaf to 1e-3 of the model's largest gradient element (the
    attention key biases, whose exact gradient is 0, hold noise only);
    the token table to a bf16 rounding more (JAX's embedding backward,
    ROADMAP.md Queue C). The knowledge leaves get a gradient."""
    got, want = cls_f32["grads"]
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.abs(np.asarray(w)).max() for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        atol = floor + (2 ** -7 * np.abs(w).max()
                        if path.endswith("/embedding") else 0.0)
        np.testing.assert_allclose(got[path], w, rtol=1e-3, atol=atol,
                                   err_msg=path)
    assert np.abs(got["knowledge_attn/k_proj/kernel"]).max() > 0


def test_classification_knowledge_train_steps_match_jax(cls_params):
    """Four AdamW steps (warmup-cosine, weight decay under the mask,
    clipping) through each package's train step and pipeline loss, the
    knowledge arrays in the batch, f32: loss and grad norm per step to
    1e-4 relative; every weight within 3 x the sum of the learning rates
    and, but for the leaves whose exact gradient is 0, each leaf's mean
    difference within 1% of its mean update."""
    b = _cls_batch(seed=3)
    opt_cfg = dict(learning_rate=1e-3)
    sched = dict(name="warmup_cosine", warmup_steps=2, total_steps=10)
    with _forced_bf16_as_f32():
        jm = JVM.VietnameseVQAModel(_cls_config(JC))
        tx = JO.create_optimizer(JO.OptimizerConfig(**opt_cfg),
                                 JO.SchedulerConfig(**sched),
                                 params=cls_params)
        jstate = JS.TrainState.create(jm.apply, cls_params, tx,
                                      jax.random.PRNGKey(0))
        jstep = jax.jit(JS.make_train_step(_jax_cls_loss()))
        jb = _jnp(b)
        jmetrics = []
        for _ in range(4):
            jstate, m = jstep(jstate, jb)
            jmetrics.append(m)
    model = _as_f32(_cls_port(cls_params))
    state = PS.TrainState.create(
        model, PO.create_optimizer(PO.OptimizerConfig(**opt_cfg), model,
                                   PO.SchedulerConfig(**sched)), seed=0)
    step = PS.make_train_step(PS.classification_loss_fn())
    tb = _torch(b)
    for i, jm_ in enumerate(jmetrics):
        state, m = step(state, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
    want = flatten_params(jax.device_get(jstate.params))
    start = flatten_params(cls_params)
    got = to_flax(model, dict(model.named_parameters()),
                  {k: v.shape for k, v in want.items()})
    lr_sum = sum(state.schedule(i) for i in range(4))
    for path, w in want.items():
        w = np.asarray(w)
        diff = np.abs(got[path] - w)
        update = np.abs(w - start[path]).mean()
        assert diff.max() <= 3 * lr_sum, (path, diff.max(), lr_sum)
        if not path.endswith(("/key/bias", "/att_fc2/bias")):
            assert diff.mean() <= 0.01 * update, (path, diff.mean(), update)


# -- generative ---------------------------------------------------------------
GEN_CASES = {"greedy": ("greedy", 16), "greedy_no_eos": ("greedy", 49),
             "beam": ("beam", 16), "beam_no_eos": ("beam", 49)}


def _gen_config(mod):
    """gen_config with knowledge and every dropout at 0 (the text
    encoder's too)."""
    cfg = gen_config(mod, "float32")
    return cfg.replace(text=cfg.text.replace(dropout=0.0),
                       knowledge=mod.KnowledgeModelConfig(
                           use_knowledge=True, knowledge_dim=DK,
                           num_retrieved=K))


def _gen_batch(seed=0):
    """gen_inputs' padded questions and answers, GenerativeVQADataset's
    targets, and the knowledge arrays of three samples (K, 3 and 1
    hits)."""
    px, q, qmask, dec, dmask = gen_inputs(seed)
    labels = np.full_like(dec, IGNORE_INDEX)
    for i, n in enumerate(dmask.sum(1)):
        labels[i, :n - 1] = dec[i, 1:n]
        labels[i, n - 1] = 49
    dec = np.where(dmask == 1, dec, 1).astype(np.int32)
    return {"pixel_values": px, "question_ids": q, "question_mask": qmask,
            "decoder_input_ids": dec, "decoder_mask": dmask,
            "labels": labels, **_knowledge(3, seed + 5)}


@pytest.fixture(scope="module")
def gen_pair():
    b = _gen_batch()
    jm = JGenModel(_gen_config(JC))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(
        {"params": key, "router": key}, b["pixel_values"],
        b["question_ids"], b["decoder_input_ids"],
        knowledge_embeddings=b["knowledge_embeddings"],
        knowledge_mask=b["knowledge_mask"])
    rs = np.random.RandomState(1)
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rs.standard_normal(np.shape(p)).astype(np.float32),
        jax.device_get(variables["params"]))
    return jm, params, port_with(GenerativeVQAModel(_gen_config(PC)),
                                 params)


def test_generative_knowledge_memory_matches_jax(gen_pair):
    """The memory grows by K tokens (the fused 16 + 8 then the projected
    contexts), its mask is [fusion mask; knowledge mask], all-ones
    without a knowledge mask; without embeddings it is the plain memory;
    the decode cache's cross K/V span the whole memory."""
    jm, params, port = gen_pair
    b = _gen_batch(seed=1)
    args = (b["pixel_values"], b["question_ids"], b["question_mask"])
    for mask in (b["knowledge_mask"], None):
        want = jm.apply({"params": params}, *args, None,
                        b["knowledge_embeddings"], mask, method=jm.encode)
        with torch.no_grad():
            got = port.encode(*map(t, args),
                              knowledge_embeddings=t(
                                  b["knowledge_embeddings"]),
                              knowledge_mask=None if mask is None
                              else t(mask))
        assert got["memory"].shape == (3, 16 + 8 + K, 32)
        assert_close(got["memory"], want["memory"], **F32_TOL)
        np.testing.assert_array_equal(got["memory_mask"].numpy(),
                                      np.asarray(want["memory_mask"]))
    np.testing.assert_array_equal(
        got["memory_mask"].numpy()[:, -K:], np.ones((3, K)))
    with torch.no_grad():
        plain = port.encode(*map(t, args))
        cache = port.init_cache(got["memory"], got["memory_mask"], LA)
    assert plain["memory"].shape == (3, 24, 32)
    assert cache.cross_kv.shape[3] == 24 + K
    assert cache.cross_mask.shape == (3, 1, 1, 24 + K)


def _port_gen_loss(model, b):
    model.zero_grad(set_to_none=True)
    loss, aux = PS.generative_loss_fn(label_smoothing=0.1)(
        model.train(), _torch(b), torch.Generator().manual_seed(0))
    loss.backward()
    model.eval()
    return loss, aux


def test_generative_knowledge_logits_and_every_gradient_match_jax(gen_pair):
    """Teacher-forced logits, the loss of the JAX pipeline's own loss
    function (label smoothing 0.1) and every gradient leaf, f32: 1e-5
    (the key biases to an absolute 1e-6; the embedding tables to a bf16
    rounding, JAX's embedding backward, ROADMAP.md Queue C)."""
    jm, params, port = gen_pair
    b = _gen_batch()
    names = ("pixel_values", "question_ids", "decoder_input_ids",
             "question_mask", "decoder_mask")
    want_logits = jm.apply({"params": params}, *(b[n] for n in names),
                           knowledge_embeddings=b["knowledge_embeddings"],
                           knowledge_mask=b["knowledge_mask"])["logits"]
    with torch.no_grad():
        got_logits = port(*(t(b[n]) for n in names),
                          **_torch({k: b[k] for k in PS.KNOWLEDGE_KEYS}))
    assert_close(got_logits["logits"], want_logits, **F32_TOL)
    (want_loss, want_aux), grads = jax.jit(
        jax.value_and_grad(JGenPipeline(JGenCfg(label_smoothing=0.1))
                           ._loss_fn(), has_aux=True),
        static_argnums=(3,))(params, _jnp(b), jax.random.PRNGKey(0),
                             jm.apply)
    want = flatten_params(jax.device_get(grads))
    loss, aux = _port_gen_loss(port, b)
    got = to_flax(port, {n: p.grad for n, p in port.named_parameters()},
                  {k: v.shape for k, v in want.items()})
    assert sorted(got) == sorted(want)
    assert "knowledge_proj/kernel" in got and "knowledge_ln/scale" in got
    assert_close(loss, want_loss, **F32_TOL)
    assert int(aux["n_tokens"]) == int(want_aux["n_tokens"])
    for path, w in want.items():
        w = np.asarray(w)
        if path.endswith("token_embed/embedding"):
            assert_close_bf16(got[path], w, max_rel=2 ** -8,
                              mean_rel=2 ** -9, msg=path)
        else:
            atol = 1e-6 if path.endswith("/key/bias") else 1e-5
            assert_close(got[path], w, atol=atol, rtol=1e-5, msg=path)


@pytest.fixture(scope="module")
def jax_generated(gen_pair):
    """JAX generate with the knowledge arrays, jitted once per case."""
    jm, params, _ = gen_pair
    b = _gen_batch(seed=7)
    out = {}
    for case, (strategy, eos) in GEN_CASES.items():
        gen = jax.jit(jdec.build_generate_fn(jm, _decode_config(
            jdec, strategy, eos)))
        seqs, scores = gen(params, b["pixel_values"], b["question_ids"],
                           b["question_mask"],
                           knowledge_embeddings=b["knowledge_embeddings"],
                           knowledge_mask=b["knowledge_mask"])
        out[case] = np.asarray(seqs), np.asarray(scores)
    return out


def _decode_config(mod, strategy, eos):
    return mod.DecodeConfig(max_length=LA, strategy=strategy, num_beams=4,
                            bos_token_id=0, eos_token_id=eos,
                            pad_token_id=1)


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_with_knowledge_token_identical_to_jax(gen_pair,
                                                        jax_generated, case):
    """Greedy and beam (the beam tiles the memory with its knowledge
    tokens) against JAX's generate on the tiny f32 model; the knowledge
    changes the answers."""
    _, _, port = gen_pair
    b = _gen_batch(seed=7)
    gen = pdec.build_generate_fn(port, _decode_config(pdec, *GEN_CASES[case]))
    args = (t(b["pixel_values"]), t(b["question_ids"]),
            t(b["question_mask"]))
    seqs, scores = gen(*args, knowledge_embeddings=t(
        b["knowledge_embeddings"]), knowledge_mask=t(b["knowledge_mask"]))
    want_seqs, want_scores = jax_generated[case]
    np.testing.assert_array_equal(seqs.numpy(), want_seqs)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=1e-5,
                               atol=1e-5)
    _, plain_scores = gen(*args)
    assert not torch.equal(plain_scores, scores)
