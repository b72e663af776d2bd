"""The whole slice: ``VietnameseVQAModel`` and ``VQAPredictor`` of the port
against the JAX package at the flagship's structure (CLIP-style ViT,
PhoBERT-style text encoder with padding, MCAN, dense top-2 MoE, answer
head) and tiny widths; the copies of the host-side helpers; and the
guards that keep the port free of JAX and off the CPU by default."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_support import (assert_close, assert_close_bf16, jax_params,
                                padding_mask, port_with)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.vqa_model import (VietnameseVQAModel,
                                              create_vqa_model)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _config(mod, dtype: str):
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(backbone="clip", image_size=32,
                                       patch_size=8, hidden_dim=32,
                                       num_layers=2, num_heads=2,
                                       vit_style="clip", dtype=dtype),
        text=mod.TextEncoderConfig(backbone="phobert", vocab_size=100,
                                   hidden_dim=32, num_layers=2, num_heads=2,
                                   max_length=8, dtype=dtype),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=2),
        moe=mod.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                               expert_hidden_dim=48),
        num_answers=16, dtype=dtype)


def _batch(B=4, seed=0):
    rs = np.random.RandomState(seed)
    px = rs.standard_normal((B, 32, 32, 3)).astype(np.float32)
    mask = padding_mask(rs.randint(1, 9, B), 8)
    mask[0] = 1                                   # one unpadded question
    ids = (rs.randint(4, 100, (B, 8)) * mask).astype(np.int32)
    return px, ids, mask


def _pair(dtype: str):
    px, ids, mask = _batch()
    jm = JModel(_config(JC, dtype))
    key = jax.random.PRNGKey(0)
    params = jax_params(jm, px, ids, mask, rngs={"params": key,
                                                 "router": key})
    return jm, params, port_with(VietnameseVQAModel(_config(PC, dtype)),
                                 params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vqa_model_matches_jax(dtype):
    """Logits, pooled features, aux_loss and router metrics on a padded
    batch. MCAN, the MoE and the head's hidden layer run in bf16 whatever
    the config says, so logits and features are held with
    assert_close_bf16. aux_loss and the metrics come from the f32 router
    over those bf16 tokens: a token whose 2nd and 3rd expert are within
    bf16 noise may swap, which moves aux_loss by at most
    0.01 * E * 2 / T * max prob (~1e-3 here), so aux is held to 2e-3
    absolute and the usage counts to 2 tokens of T."""
    jm, params, port = _pair(dtype)
    px, ids, mask = _batch()
    want = jm.apply({"params": params}, px, ids, mask)
    with torch.inference_mode():
        got = port(torch.from_numpy(px), torch.from_numpy(ids).long(),
                   torch.from_numpy(mask))
    assert got["logits"].dtype == torch.float32
    assert_close_bf16(got["logits"], want["logits"], msg="logits")
    assert_close_bf16(got["features"], want["features"], msg="features")
    assert_close(got["aux_loss"], want["aux_loss"], atol=2e-3, rtol=0)
    T = px.shape[0] * (16 + 8)
    assert_close(got["moe_metrics"]["expert_usage"],
                 want["moe_metrics"]["expert_usage"], atol=2 / T + 1e-6,
                 rtol=0)
    assert np.isfinite(got["logits"].numpy()).all()


def test_vqa_model_expert_mask():
    jm, params, port = _pair("float32")
    px, ids, mask = _batch(seed=1)
    em = np.array([1, 1, 0, 1], np.float32)
    want = jm.apply({"params": params}, px, ids, mask, expert_mask=em)
    with torch.inference_mode():
        got = port(torch.from_numpy(px), torch.from_numpy(ids).long(),
                   torch.from_numpy(mask), torch.from_numpy(em))
    assert float(got["moe_metrics"]["expert_usage"][2]) == 0.0
    assert_close_bf16(got["logits"], want["logits"], msg="logits")


def _predictors():
    from vivqa_tpu.data.tokenizer import WhitespaceTokenizer as JTok
    from vivqa_tpu.eval.predictor import VQAPredictor as JPred
    from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from vivqa_tpu_torch.eval.predictor import VQAPredictor
    corpus = ["màu gì", "có bao nhiêu con mèo", "cái gì ở trên bàn",
              "người đàn ông đang làm gì vậy"]
    jtok, tok = JTok(max_length=8), WhitespaceTokenizer(max_length=8)
    jtok.build_vocab(corpus)
    tok.build_vocab(corpus)
    id2answer = {i: f"answer_{i}" for i in range(16)}
    jm, params, port = _pair("float32")
    return (JPred(jm, params, jtok, id2answer, image_size=32, top_k=3,
                  batch_pad=4),
            VQAPredictor(port, tok, id2answer, image_size=32, top_k=3,
                         batch_pad=4, device="cpu"),
            corpus)


def test_predictor_matches_jax():
    """Top-k answers and confidences of predict_batch (5 requests, padded
    to 8) and predict. Confidences are softmax outputs of bf16-level
    logits; an answer pair is held to the same order only where the JAX
    confidences differ by more than that noise."""
    jpred, pred, corpus = _predictors()
    rs = np.random.RandomState(2)
    images = [rs.randint(0, 256, (40, 48, 3), dtype=np.uint8)
              for _ in range(5)]
    questions = corpus + ["màu gì vậy"]
    want = jpred.predict_batch(images, questions)
    got = pred.predict_batch(images, questions)
    got.append(pred.predict(images[0], questions[0]))
    want.append(jpred.predict(images[0], questions[0]))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.question == w.question and g.inference_ms > 0
        wc = [a["confidence"] for a in w.top_answers]
        gc = {a["answer"]: a["confidence"] for a in g.top_answers}
        for i, a in enumerate(w.top_answers):
            margin = min(abs(wc[i] - wc[j]) for j in range(len(wc)) if j != i)
            if margin > 0.02:
                assert a["answer"] in gc and abs(
                    gc[a["answer"]] - a["confidence"]) < 0.02, (g, w)
        if wc[0] - wc[1] > 0.02:
            assert g.answer == w.answer


def test_tokenizer_copy_matches():
    from vivqa_tpu.data.tokenizer import WhitespaceTokenizer as JTok
    from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    corpus = ["Cái gì, ở đâu?", "Con mèo màu gì"]
    j, p = JTok(max_length=6), WhitespaceTokenizer(max_length=6)
    j.build_vocab(corpus)
    p.build_vocab(corpus)
    texts = corpus + ["một câu hỏi rất dài hơn sáu từ nhiều lắm", "mèo"]
    for key, value in j.encode_batch(texts).items():
        np.testing.assert_array_equal(p.encode_batch(texts)[key], value)
    np.testing.assert_array_equal(p.encode(texts[0], add_special_tokens=True),
                                  j.encode(texts[0], add_special_tokens=True))


def test_eval_transform_copy_matches():
    from vivqa_tpu.data.augmentation import ImageAugmentation as JAug
    from vivqa_tpu_torch.data.augmentation import ImageAugmentation
    rs = np.random.RandomState(3)
    for img in (rs.randint(0, 256, (37, 23, 3), dtype=np.uint8),
                rs.rand(20, 20, 3).astype(np.float32), "/nonexistent.jpg"):
        np.testing.assert_array_equal(ImageAugmentation(16)(img),
                                      JAug(16, mode="eval")(img))


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py import without JAX and
    without the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "vivqa_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vivqa_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(modules) > 20


def test_default_device_raises_without_cuda():
    """The entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from vivqa_tpu_torch.eval.predictor import VQAPredictor
    cfg = _config(PC, "float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_vqa_model(cfg)
    model = create_vqa_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        VQAPredictor(model, WhitespaceTokenizer(), {})
