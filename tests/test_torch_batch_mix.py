"""``vivqa_tpu_torch/ops/batch_mix.py`` and the rest of the loss zoo
(``train/losses.py``) against the JAX package.

The port draws from a ``torch.Generator`` where JAX splits a key, so the
mixes are held to JAX on given draws (JAX's own λ and box centre, read
from the same key splits ``vivqa_tpu/ops/batch_mix.py`` makes) to f32
rounding, and the port's draws are held to their law: λ ~ Beta(α, α) by
a Kolmogorov-Smirnov test, the box centre uniform over [0, W] x [0, H]
and the coin fair by chi-square tests, each at p > 1e-3 (seeded, so the
outcome is fixed). The pipeline's mixed loss and its gradient are held
to the JAX pipeline's on JAX's draws.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from test_torch_support import (as_f32, assert_close_bf16, forced_bf16_as_f32,
                                padding_mask, small_cls_config,
                                small_cls_params)
from vivqa_tpu.ops import batch_mix as JB
from vivqa_tpu.train import losses as JL
from vivqa_tpu_torch.ops import batch_mix as PB
from vivqa_tpu_torch.train import losses as PL

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-6)


def _images(B=5, H=12, W=16, seed=0):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


@pytest.mark.parametrize("alpha", [0.4, 2.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_matches_jax_on_its_lambda(alpha, seed):
    x = _images(seed=seed)
    want, jperm, lam = JB.mixup(jax.random.PRNGKey(seed), jnp.asarray(x),
                                alpha)
    got, perm, plam = PB.mixup(None, torch.from_numpy(x), alpha,
                               lam=torch.tensor(float(lam)))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(plam) == float(lam)


def _jax_cutmix_draws(key, alpha, H, W):
    """The λ and centre ``vivqa_tpu/ops/batch_mix.py:cutmix`` draws."""
    k_lam, k_cx, k_cy = jax.random.split(key, 3)
    return (float(JB.sample_lambda(k_lam, alpha)),
            int(jax.random.randint(k_cx, (), 0, W + 1)),
            int(jax.random.randint(k_cy, (), 0, H + 1)))


@pytest.mark.parametrize("seed", range(8))
def test_cutmix_matches_jax_on_its_box(seed):
    """Boxes over 8 keys, among them boxes clipped at the image's edges:
    the mixed images and λ re-adjusted to the clipped area."""
    x = _images(seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    want, jperm, jlam = JB.cutmix(key, jnp.asarray(x), 1.0)
    lam, cx, cy = _jax_cutmix_draws(key, 1.0, 12, 16)
    got, perm, plam = PB.cutmix(None, torch.from_numpy(x), 1.0,
                                lam=torch.tensor(lam), center=(cx, cy))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(plam), float(jlam), **TOL)


def test_both_picks_one_mix_by_its_coin():
    x = torch.from_numpy(_images())
    draw = {"lam": torch.tensor(0.7), "cx": torch.tensor(3),
            "cy": torch.tensor(11)}
    m_img, _, m_lam = PB.apply_mix(x, "mixup", draw)
    c_img, _, c_lam = PB.apply_mix(x, "cutmix", draw)
    for coin, img, lam in ((True, m_img, m_lam), (False, c_img, c_lam)):
        got, _, glam = PB.apply_mix(x, "both",
                                    {**draw, "use_mixup": torch.tensor(coin)})
        assert torch.equal(got, img) and float(glam) == float(lam)
    with pytest.raises(ValueError, match="unknown mix mode"):
        PB.mix_batch(torch.Generator(), x, "mosaic", 1.0)


@pytest.mark.parametrize("alpha", [0.2, 1.0, 3.0])
def test_lambda_follows_beta(alpha):
    g = torch.Generator().manual_seed(7)
    draws = np.array([float(PB.sample_lambda(g, alpha))
                      for _ in range(1500)])
    assert ((draws >= 0) & (draws <= 1)).all()
    assert stats.kstest(draws, stats.beta(alpha, alpha).cdf).pvalue > 1e-3
    assert float(PB.sample_lambda(g, 0.0)) == 1.0


def test_box_centre_and_coin_follow_their_law():
    g = torch.Generator().manual_seed(3)
    H, W = 5, 7
    draws = [PB.draw_mix(g, "both", 1.0, H, W) for _ in range(2000)]
    cx = np.array([int(d["cx"]) for d in draws])
    cy = np.array([int(d["cy"]) for d in draws])
    coin = np.array([bool(d["use_mixup"]) for d in draws])
    assert cx.min() == 0 and cx.max() == W and cy.max() == H
    for values, n in ((cx, W + 1), (cy, H + 1)):
        counts = np.bincount(values, minlength=n)
        assert stats.chisquare(counts).pvalue > 1e-3
    assert stats.binomtest(int(coin.sum()), coin.size).pvalue > 1e-3
    # the step's mix is drawn from the generator alone
    x = torch.from_numpy(_images())
    a = PB.mix_batch(torch.Generator().manual_seed(1), x, "both", 0.4)
    torch.manual_seed(5)
    b = PB.mix_batch(torch.Generator().manual_seed(1), x, "both", 0.4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_mixed_targets_and_cross_entropy_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((6, 9)).astype(np.float32)
    a, b = rs.randint(0, 9, 6), rs.randint(0, 9, 6)
    lam = np.float32(0.3)
    np.testing.assert_allclose(
        PB.mixed_soft_targets(torch.from_numpy(a), torch.from_numpy(b),
                              torch.tensor(lam), 9).numpy(),
        np.asarray(JB.mixed_soft_targets(a, b, lam, 9)), **TOL)
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            float(PB.mixed_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(a),
                                         torch.from_numpy(b),
                                         torch.tensor(lam), smoothing)),
            float(JB.mixed_cross_entropy(logits, a, b, lam, smoothing)),
            rtol=1e-6)


# -- the loss zoo ------------------------------------------------------------
def _loss_inputs(rs):
    logits = rs.standard_normal((6, 9)).astype(np.float32) * 3
    labels = rs.randint(0, 9, 6)
    soft = rs.rand(6, 9).astype(np.float32)
    emb = [rs.standard_normal((6, 16)).astype(np.float32) for _ in range(3)]
    return logits, labels, soft, emb


@pytest.mark.parametrize("name", ["cross_entropy", "bce", "focal",
                                  "label_smoothing", "soft_target",
                                  "contrastive", "triplet", "infonce"])
def test_loss_zoo_matches_jax(name):
    """Each loss of ``create_loss`` on seeded inputs, f32 to 1e-5."""
    logits, labels, soft, (e1, e2, e3) = _loss_inputs(
        np.random.RandomState(1))
    t = torch.from_numpy
    args = {"cross_entropy": ((logits, labels), {}),
            "label_smoothing": ((logits, labels),
                                {"label_smoothing": 0.1}),
            "bce": ((logits, soft), {}), "soft_target": ((logits, soft), {}),
            "focal": ((logits, labels), {"gamma": 1.5, "alpha": 0.3}),
            "contrastive": ((e1, e2), {"temperature": 0.1}),
            "infonce": ((e1, e2), {}),
            "triplet": ((e1, e2, e3), {"margin": 4.0})}[name]
    want = JL.create_loss(name)(*args[0], **args[1])
    got = PL.create_loss(name)(*(t(a) for a in args[0]), **args[1])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        PL.create_loss("hinge")


def test_multitask_loss_matches_jax():
    for kw in ({}, {"answer_weight": 0.5, "aux_weight": 0.1,
                    "consistency_weight": 2.0}):
        j, p = JL.MultiTaskLoss(**kw), PL.MultiTaskLoss(**kw)
        np.testing.assert_allclose(
            float(p(torch.tensor(1.5), torch.tensor(0.2), 0.7)),
            float(j(1.5, 0.2, 0.7)), rtol=1e-6)
        lv = np.array([0.1, -0.3, 0.5], np.float32)
        np.testing.assert_allclose(
            float(p(torch.tensor(1.5), 0.2, 0.7, log_vars=torch.from_numpy(lv))),
            float(j(jnp.float32(1.5), jnp.float32(0.2), jnp.float32(0.7),
                    log_vars=lv)), rtol=1e-6)


# -- the mixed training loss against the JAX pipeline's ------------------------
def _cls_batch(seed=0):
    rs = np.random.RandomState(seed)
    mask = padding_mask([8, 5, 2, 7], 8)
    return {"pixel_values": rs.standard_normal((4, 16, 16, 3)).astype(
                np.float32),
            "input_ids": (rs.randint(4, 50, (4, 8)) * mask).astype(np.int32),
            "attention_mask": mask,
            "labels": rs.randint(0, 10, 4).astype(np.int32)}


def _jax_draw(rng, mode: str, alpha: float, H: int, W: int) -> dict:
    """The draws of the JAX pipeline's ``_loss_fn`` under ``rng``
    (``rng, k_mix = split(rng)``, then ``mix_batch(k_mix, ...)``), as the
    port's ``draw_mix`` keys; for ``both`` the λ of the branch its coin
    takes."""
    _, k_mix = jax.random.split(rng)
    if mode == "both":
        k_coin, k_mix = jax.random.split(k_mix)
        use_mixup = bool(jax.random.bernoulli(k_coin))
        draw = (_jax_draw_one(k_mix, "mixup", alpha, H, W) if use_mixup
                else _jax_draw_one(k_mix, "cutmix", alpha, H, W))
        return {**draw, "use_mixup": torch.tensor(use_mixup)}
    return _jax_draw_one(k_mix, mode, alpha, H, W)


def _jax_draw_one(key, mode, alpha, H, W) -> dict:
    if mode == "mixup":
        lam = float(JB.sample_lambda(key, alpha))
        return {"lam": torch.tensor(lam), "cx": torch.tensor(0),
                "cy": torch.tensor(0)}
    lam, cx, cy = _jax_cutmix_draws(key, alpha, H, W)
    return {"lam": torch.tensor(lam), "cx": torch.tensor(cx),
            "cy": torch.tensor(cy)}


_JAX_GRADS = {}


@pytest.fixture(scope="module")
def cls_params():
    return small_cls_params(_cls_batch())


@pytest.mark.parametrize("mode,seed", [("mixup", 0), ("cutmix", 0),
                                       ("both", 0), ("both", 3)])
def test_mixed_loss_and_gradients_match_the_jax_pipeline(cls_params, mode,
                                                         seed, monkeypatch):
    """The JAX training pipeline's own mixed loss and its gradient (f32,
    the forced-bf16 modules patched, dropout 0) against the port's
    ``classification_loss_fn`` with the mix, given JAX's draws (seeds 0
    and 3 take each side of the ``both`` coin): loss, accuracy and every
    gradient leaf to 1e-5 (the embeddings' to a bf16 rounding)."""
    from vivqa_tpu.models import config as JC
    from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
    from vivqa_tpu.pipelines import training_pipeline as JTP
    from vivqa_tpu_torch.models import config as PC
    from vivqa_tpu_torch.models.from_jax import (flatten_params,
                                                 load_flax_params, to_flax)
    from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
    from vivqa_tpu_torch.train import state as PS
    b = _cls_batch(seed=1)
    rng = jax.random.PRNGKey(seed)
    with forced_bf16_as_f32():
        if mode not in _JAX_GRADS:          # one compile per mode
            loss_fn = JTP.TrainingPipeline(JTP.TrainingPipelineConfig(
                mix_mode=mode, mix_alpha=0.4))._loss_fn()
            _JAX_GRADS[mode] = (jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True), static_argnums=(3,)),
                JModel(small_cls_config(JC)).apply)
        fn, apply = _JAX_GRADS[mode]
        (want, jmetrics), jgrads = fn(
            cls_params, {k: jnp.asarray(v) for k, v in b.items()}, rng,
            apply)
    draw = _jax_draw(rng, mode, 0.4, 16, 16)
    monkeypatch.setattr(PB, "draw_mix", lambda *a: dict(draw))
    model = as_f32(load_flax_params(VietnameseVQAModel(small_cls_config(PC)),
                                    cls_params)).train()
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
          else torch.from_numpy(v) for k, v in b.items()}
    loss, metrics = PS.classification_loss_fn(mix_mode=mode, mix_alpha=0.4)(
        model, tb, torch.Generator())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jmetrics["accuracy"]), atol=1e-6)
    flat = flatten_params(jax.device_get(jgrads))
    got = to_flax(model, {n: p.grad for n, p in model.named_parameters()},
                  {k: v.shape for k, v in flat.items()})
    for path, g in flat.items():
        if path.endswith("embedding"):
            # JAX's embedding backward rounds its incoming gradient to
            # bf16 even in an f32 model (ops/embedding.py)
            assert_close_bf16(got[path], g, msg=path)
        else:
            np.testing.assert_allclose(got[path], np.asarray(g), atol=1e-5,
                                       rtol=1e-4, err_msg=path)
