"""Generative training of the port against the JAX package, on the CPU:
the onecycle schedule, the teacher-forcing loss and its gradient against
``jax.grad`` of the JAX pipeline's own loss function, four train steps
against the JAX train step, the copied dataset targets, collates and
metrics, the checkpoint manager's retention against orbax's, and
``GenerativeTrainingPipeline.run`` end to end on the tiny model."""

from __future__ import annotations

import logging
import tempfile
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, assert_close, assert_close_bf16,
                                gen_config, gen_inputs, gen_model_pair,
                                port_with, t)
from vivqa_tpu import metrics as JM
from vivqa_tpu.data import dataset as JD
from vivqa_tpu.data.augmentation import ImageAugmentation as JAug
from vivqa_tpu.data.schema import OneSample as JSample
from vivqa_tpu.data.tokenizer import WhitespaceTokenizer as JTok
from vivqa_tpu.data.vocab import build_answer_vocab as j_answer_vocab
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.generative import GenerativeVQAModel as JModel
from vivqa_tpu.pipelines import common as JCommon
from vivqa_tpu.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig as JGenCfg,
    GenerativeTrainingPipeline as JGenPipeline)
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu.train import state as JS
from vivqa_tpu.train.checkpoint import CheckpointConfig as JCkptCfg
from vivqa_tpu.train.checkpoint import CheckpointManager as JCkpt
from vivqa_tpu_torch import metrics as PM
from vivqa_tpu_torch.data import dataset as PD
from vivqa_tpu_torch.data.augmentation import ImageAugmentation as PAug
from vivqa_tpu_torch.data.schema import OneSample as PSample
from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer as PTok
from vivqa_tpu_torch.data.vocab import build_answer_vocab as p_answer_vocab
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import flatten_params, to_flax
from vivqa_tpu_torch.models.generative import (GenerativeVQAModel,
                                               create_generative_vqa_model)
from vivqa_tpu_torch.models.layers import init_weights
from vivqa_tpu_torch.pipelines import common as PCommon
from vivqa_tpu_torch.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig, GenerativeTrainingPipeline)
from vivqa_tpu_torch.train import optimizers as PO
from vivqa_tpu_torch.train import state as PS
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager)
from vivqa_tpu_torch.train.losses import cross_entropy_loss

torch.set_num_threads(1)
logging.getLogger("absl").setLevel(logging.ERROR)


# -- onecycle ----------------------------------------------------------------
@pytest.mark.parametrize("total,extra", [
    (20, {}), (20, {"warmup_steps": 3}), (20, {"warmup_steps": 19}),
    (20, {"warmup_steps": 50}), (1, {}), (2, {})], ids=str)
def test_onecycle_matches_optax(total, extra):
    """The default schedule of the generative pipeline at every count of
    the run and past it, and at the degenerate totals 1 and 2 (raised to
    2 by the reference's guard). optax computes in f32, the port in f64:
    relative 1e-5."""
    cfg = dict(name="onecycle", total_steps=total, **extra)
    want = JO.create_schedule(JO.SchedulerConfig(**cfg), 1e-3)
    got = PO.create_schedule(PO.SchedulerConfig(**cfg), 1e-3)
    for step in range(max(total, 2) + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {step}")


def test_onecycle_zero_width_ramp_is_a_reference_fault():
    """warmup 1 of 49 steps: pct_start = 1/49, and int(1/49 * 49) is 0,
    so optax's first interval has zero width and the reference's schedule
    is NaN at every count (its guard does not see the float rounding).
    The port's ramp of zero steps starts at the peak and decays from
    there (ROADMAP.md, Queue C)."""
    cfg = dict(name="onecycle", warmup_steps=1, total_steps=49)
    want = JO.create_schedule(JO.SchedulerConfig(**cfg), 1e-3)
    got = PO.create_schedule(PO.SchedulerConfig(**cfg), 1e-3)
    with np.errstate(all="ignore"):
        assert np.isnan(float(want(0))) and np.isnan(float(want(48)))
    assert got(0) == 1e-3 and 0 < got(48) < got(1) < got(0)
    np.testing.assert_allclose(got(49), 1e-3 / 25 / 1e4, rtol=1e-12)


# -- the loss and its gradient ---------------------------------------------
EOS, PAD = 49, 1                 # gen_config's eos and pad ids


def _batch(seed: int = 0) -> dict:
    """gen_inputs' padded questions (8, 5, 2 tokens) and answers of 6, 4
    and 1 positions as GenerativeVQADataset builds its targets: labels are
    the next token, EOS after the last, IGNORE_INDEX on padding."""
    px, q, qmask, dec, dmask = gen_inputs(seed)
    labels = np.full_like(dec, JD.IGNORE_INDEX)
    for b, n in enumerate(dmask.sum(1)):
        labels[b, :n - 1] = dec[b, 1:n]
        labels[b, n - 1] = EOS
    dec = np.where(dmask == 1, dec, PAD).astype(np.int32)
    return {"pixel_values": px, "question_ids": q, "question_mask": qmask,
            "decoder_input_ids": dec, "decoder_mask": dmask,
            "labels": labels}


def _config(mod, dtype: str):
    """gen_config with every dropout at 0, the text encoder's too (0.1 by
    its config), so that the training forwards of the two packages
    compute the same function."""
    cfg = gen_config(mod, dtype)
    return cfg.replace(text=cfg.text.replace(dropout=0.0))


def _jax_loss_fn():
    """The JAX pipeline's own loss function at label smoothing 0.1."""
    return JGenPipeline(JGenCfg(label_smoothing=0.1))._loss_fn()


@pytest.fixture(scope="module")
def pairs():
    """dtype -> (JAX model, params, the port's model with those params)
    and dtype -> the JAX loss, aux and gradient on ``_batch()``, each made
    once. The params are f32 whatever the compute dtype, so both dtypes
    share one JAX init."""
    _, params, _ = gen_model_pair("float32")
    models, grads = {}, {}

    def get(dtype):
        if dtype not in models:
            models[dtype] = (JModel(_config(JC, dtype)), params,
                             port_with(GenerativeVQAModel(_config(PC, dtype)),
                                       params))
        return models[dtype]

    def jax_grad(dtype):
        if dtype not in grads:
            jm = get(dtype)[0]
            jb = {k: jnp.asarray(v) for k, v in _batch().items()}
            (loss, aux), g = jax.jit(
                jax.value_and_grad(_jax_loss_fn(), has_aux=True),
                static_argnums=(3,))(params, jb, jax.random.PRNGKey(0),
                                     jm.apply)
            grads[dtype] = (loss, aux, flatten_params(jax.device_get(g)))
        return grads[dtype]
    get.jax_grad = jax_grad
    return get


# the attention key bias: a softmax ignores a shift of all its inputs,
# so the exact gradient is 0 and both sides hold rounding noise only
ZERO_GRADIENT_LEAVES = ("/key/bias",)
# the question encoder's table and the decoder's tied one
EMBEDDINGS = "token_embed/embedding"


def _port_loss_and_grads(model, shapes):
    model.zero_grad(set_to_none=True)
    loss, aux = PS.generative_loss_fn(label_smoothing=0.1)(
        model.train(), {k: t(v) for k, v in _batch().items()},
        torch.Generator().manual_seed(0))
    loss.backward()
    model.eval()
    grads = to_flax(model, {n: p.grad for n, p in model.named_parameters()},
                    shapes)
    return loss, aux, grads


def test_generative_loss_and_every_gradient_match_jax_f32(pairs):
    """Loss, ce, n_tokens and every gradient leaf at dropout 0 and label
    smoothing 0.1, with padded questions (fully masked fusion rows) and
    answers of 6, 4 and 1 positions (IGNORE_INDEX labels, fully masked
    decoder rows), f32: 1e-5 (F32_TOL), the key biases to an absolute
    1e-6.

    The embedding tables take the "embedding" rule of ROADMAP.md Queue C:
    JAX's one-hot-matmul backward rounds the incoming gradient to bf16
    even for an f32 model, where the port sums it in f32, so the two
    agree to a bf16 rounding (max 2**-8 of the largest element, mean 2**-9
    of the mean, as
    test_torch_train.py::test_embedding_gradient_matches_matmul_grad_embed
    holds it). The decoder's tied table adds the f32 logits GEMM's
    gradient to the gather's; autograd adds a shared input's gradients in
    recorded order (Queue C, "gradient order"), which moves nothing past
    that bound."""
    model = pairs("float32")[2]
    want_loss, want_aux, want = pairs.jax_grad("float32")
    loss, aux, got = _port_loss_and_grads(model, {k: v.shape for k, v in
                                                  want.items()})
    assert sorted(got) == sorted(want)
    assert int(aux["n_tokens"]) == int(want_aux["n_tokens"]) == 6 + 4 + 1
    assert float(aux["aux_loss"]) == float(want_aux["aux_loss"]) == 0.0
    assert_close(loss, want_loss, **F32_TOL, msg="loss")
    assert_close(aux["ce"], want_aux["ce"], **F32_TOL, msg="ce")
    for path, w in want.items():
        w = np.asarray(w)
        if path.endswith(EMBEDDINGS):
            assert_close_bf16(got[path], w, max_rel=2 ** -8,
                              mean_rel=2 ** -9, msg=path)
        else:
            atol = 1e-6 if path.endswith(ZERO_GRADIENT_LEAVES) else 1e-5
            assert_close(got[path], w, atol=atol, rtol=1e-5, msg=path)


BF16_GRAD_REL = 0.1


def test_generative_gradient_bf16_as_close_as_jax(pairs):
    """The same in bf16. Both frameworks round at other points (flax's
    attention rounds its logits and probabilities to bf16, the port's
    kernels keep them in f32: Queue C, "attention precision"), and the
    gradients of the attention scores are differences of such values, so
    the two bf16 gradients are held to the f32 gradient of the same
    weights, each leaf with assert_close_bf16 at BF16_GRAD_REL (10%) of
    its largest and mean element: the JAX package's own bf16 gradient
    meets that bound on these inputs (asserted here; it reaches 8.2% and
    8.1%), the port's lies closer. The key biases' exact gradient is 0:
    both are held to 1e-3 of the largest gradient element. The loss
    agrees with JAX's bf16 loss to 1e-2 and n_tokens exactly."""
    model = pairs("bfloat16")[2]
    _, _, exact = pairs.jax_grad("float32")
    want_loss, want_aux, want = pairs.jax_grad("bfloat16")
    loss, aux, got = _port_loss_and_grads(model, {k: v.shape for k, v in
                                                  want.items()})
    assert sorted(got) == sorted(want)
    assert int(aux["n_tokens"]) == int(want_aux["n_tokens"])
    assert_close(loss, want_loss, atol=0, rtol=1e-2, msg="loss")
    floor = 1e-3 * max(np.abs(np.asarray(w)).max() for w in exact.values())
    for path, w in exact.items():
        w = np.asarray(w)
        for side, grad in (("port", got[path]), ("jax", want[path])):
            if path.endswith(ZERO_GRADIENT_LEAVES):
                assert np.abs(grad - w).max() <= floor, (side, path)
            else:
                assert_close_bf16(grad, w, max_rel=BF16_GRAD_REL,
                                  mean_rel=BF16_GRAD_REL,
                                  msg=f"{side} {path}")


def test_generative_train_steps_match_jax(pairs):
    """Four steps of AdamW (lr 1e-3, weight decay 0.01 under the mask,
    clipping at 1.0) under the pipeline's default onecycle schedule over
    10 steps, through each package's train step and the generative loss,
    f32: test_torch_train.py's tolerances (loss and grad_norm per step
    within 1%; every weight within 3 x the sum of the learning rates;
    each leaf's mean difference within 10% of its mean update; the key
    biases, whose exact gradient is 0, to the first bound only)."""
    jm, params, _ = pairs("float32")
    model = port_with(GenerativeVQAModel(_config(PC, "float32")), params)
    b = _batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    opt_cfg = dict(learning_rate=1e-3)
    sched = dict(name="onecycle", total_steps=10)
    tx = JO.create_optimizer(JO.OptimizerConfig(**opt_cfg),
                             JO.SchedulerConfig(**sched), params=params)
    jstate = JS.TrainState.create(jm.apply, params, tx,
                                  jax.random.PRNGKey(0))
    jstep = jax.jit(JS.make_train_step(_jax_loss_fn()))
    state = PS.TrainState.create(
        model, PO.create_optimizer(PO.OptimizerConfig(**opt_cfg), model,
                                   PO.SchedulerConfig(**sched)), seed=0)
    step = PS.make_train_step(PS.generative_loss_fn(label_smoothing=0.1))
    tb = {k: t(v) for k, v in b.items()}
    for i in range(4):
        jstate, jm_ = jstep(jstate, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-2, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-2,
                                   err_msg=f"grad_norm, step {i}")
        assert int(m["n_tokens"]) == int(jm_["n_tokens"])
    want = flatten_params(jax.device_get(jstate.params))
    start = flatten_params(params)
    got = to_flax(model, dict(model.named_parameters()),
                  {k: v.shape for k, v in want.items()})
    lr_sum = sum(state.schedule(i) for i in range(4))
    for path, w in want.items():
        w = np.asarray(w)
        diff = np.abs(got[path] - w)
        update = np.abs(w - start[path]).mean()
        assert diff.max() <= 3 * lr_sum, (path, diff.max(), lr_sum)
        if not path.endswith(ZERO_GRADIENT_LEAVES):
            assert diff.mean() <= 0.1 * update, (path, diff.mean(), update)


def _labels(kind: str) -> np.ndarray:
    """_batch()'s labels as a prefix of each row, with IGNORE_INDEX holes
    inside rows, on every position, or on none."""
    labels = _batch()["labels"]
    if kind == "holes":
        labels[0, 1:3] = JD.IGNORE_INDEX
        labels[1, 1] = JD.IGNORE_INDEX
    elif kind == "all":
        labels = np.random.RandomState(1).randint(0, 50, labels.shape)
    elif kind == "none":
        labels = np.full_like(labels, JD.IGNORE_INDEX)
    return labels


def _leaf_gradients(model) -> dict:
    return {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.detach().numpy().copy()
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("labels,smoothing,moe_position", [
    ("prefix", 0.1, None), ("prefix", 0.0, None), ("holes", 0.1, None),
    ("holes", 0.0, None), ("all", 0.1, None), ("all", 0.0, None),
    ("none", 0.1, None), ("none", 0.0, None), ("prefix", 0.1, "decoder"),
    ("holes", 0.0, "decoder")], ids=str)
def test_loss_on_labelled_rows_equals_the_full_projection(
        labels, smoothing, moe_position):
    """generative_loss_fn projects only the labelled positions onto the
    vocabulary; against cross_entropy_loss over the full (B, L, vocab)
    logits of the same forward without ``rows``, in train mode with
    dropout 0.1 from the same generator seed (so no draw may have moved):
    loss, ce, n_tokens and aux_loss, and every gradient leaf, f32 to 1e-6
    of the leaf's largest element (only the order of f32 sums differs).
    With no labelled position the loss is 0 and every gradient is zero.
    The decoder MoE runs on every position either way: its aux loss and
    the router's gradient agree."""
    cfg = gen_config(PC, "float32", dropout=0.1)
    if moe_position is not None:
        cfg = cfg.replace(moe=PC.MoEModelConfig(
            use_moe=True, num_experts=2, top_k=1, expert_hidden_dim=32,
            moe_position=moe_position))
    model = GenerativeVQAModel(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    model.train()
    batch = {k: t(v) for k, v in _batch().items()}
    batch["labels"] = t(_labels(labels))

    loss, aux = PS.generative_loss_fn(label_smoothing=smoothing)(
        model, batch, torch.Generator().manual_seed(7))
    loss.backward()
    got = _leaf_gradients(model)
    model.zero_grad(set_to_none=True)

    out = model(batch["pixel_values"], batch["question_ids"],
                batch["decoder_input_ids"], batch["question_mask"],
                batch["decoder_mask"],
                generator=torch.Generator().manual_seed(7))
    assert out["logits"].shape == (*batch["labels"].shape, cfg.vocab_size)
    ce = cross_entropy_loss(out["logits"], batch["labels"], smoothing,
                            ignore_index=JD.IGNORE_INDEX)
    want_loss = ce + 0.01 * out["aux_loss"]
    want_loss.backward()
    want = _leaf_gradients(model)

    n = int((batch["labels"] != JD.IGNORE_INDEX).sum())
    assert int(aux["n_tokens"]) == n
    for name, a, b in (("loss", loss, want_loss), ("ce", aux["ce"], ce),
                       ("aux_loss", aux["aux_loss"], out["aux_loss"])):
        assert_close(a, b, atol=0, rtol=1e-6, msg=name)
    if moe_position is not None:
        assert float(aux["aux_loss"]) > 0
    if n == 0:
        assert float(loss.detach()) == 0.0
        assert not any(g.any() for g in got.values())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        assert np.abs(got[name] - w).max() <= 1e-6 * scale, (
            name, np.abs(got[name] - w).max(), scale)
    if n:
        assert np.abs(got["decoder.token_embed.weight"]).max() > 0


# -- data: targets and collates ----------------------------------------------
CORPUS = ["màu gì vậy", "có bao nhiêu con mèo", "con chó ở đâu",
          "màu đỏ", "hai", "trên bàn bên trái", "không"]


def _samples(sample_cls):
    rs = np.random.RandomState(4)
    questions = ["con mèo màu gì vậy ?", "có bao nhiêu con chó trên bàn",
                 "cái gì", "con chó ở đâu bên trái của cái bàn này vậy"]
    answers = [["màu đỏ", "đỏ", "màu đỏ"], ["hai", "ba", "ba"],
               ["không"], ["trên bàn bên trái rất xa kia nữa", "bàn"]]
    return [sample_cls(rs.randint(0, 256, (20, 24, 3), dtype=np.uint8), q, a)
            for q, a in zip(questions, answers)]


def _tokenizer(cls):
    tok = cls(max_length=8)
    tok.build_vocab(CORPUS)
    return tok


def _assert_items_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray) or np.isscalar(w):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("selection", ["majority", "random", "first"])
def test_generative_dataset_and_collate_match_jax(selection):
    """Teacher-forcing targets (BOS + answer ids cut to L - 1, labels =
    ids + EOS, IGNORE_INDEX padding), eval pixels and generative_collate,
    item by item and batched, on the same samples and vocabulary; an
    answer longer than L - 1 is cut."""
    kw = dict(max_question_length=8, max_answer_length=5,
              answer_selection=selection, seed=3)
    want_ds = JD.GenerativeVQADataset(_samples(JSample), _tokenizer(JTok),
                                      JAug(32, mode="eval"), **kw)
    got_ds = PD.GenerativeVQADataset(_samples(PSample), _tokenizer(PTok),
                                     PAug(32, mode="eval"), **kw)
    assert PD.IGNORE_INDEX == JD.IGNORE_INDEX == -100
    want_items = [want_ds[i] for i in range(len(want_ds))]
    got_items = [got_ds[i] for i in range(len(got_ds))]
    for g, w in zip(got_items, want_items):
        _assert_items_equal(g, w)
    if selection != "random":        # its 8-word answer, cut to 4 + EOS
        assert (got_items[3]["labels"] != PD.IGNORE_INDEX).sum() == 5
    _assert_items_equal(PD.generative_collate(got_items),
                        JD.generative_collate(want_items))


def test_vqa_dataset_and_collate_match_jax():
    want_vocab = j_answer_vocab(_samples(JSample))[0]
    got_vocab = p_answer_vocab(_samples(PSample))[0]
    assert got_vocab == want_vocab
    want_ds = JD.VQADataset(_samples(JSample), _tokenizer(JTok), want_vocab,
                            JAug(32, mode="eval"), max_question_length=8)
    got_ds = PD.VQADataset(_samples(PSample), _tokenizer(PTok), got_vocab,
                           PAug(32, mode="eval"), max_question_length=8)
    items = [(got_ds[i], want_ds[i]) for i in range(len(want_ds))]
    for g, w in items:
        _assert_items_equal(g, w)
    _assert_items_equal(PD.vqa_collate([g for g, _ in items]),
                        JD.vqa_collate([w for _, w in items]))


# -- metrics -----------------------------------------------------------------
PREDS = ["màu đỏ", "ba con mèo", "", "trên bàn", "the red car",
         "a dog on the table", "xe đạp màu xanh", "Không!"]
REFS = [["màu đỏ", "đỏ"], ["hai con mèo", "ba con"], ["không"],
        "trên cái bàn", ["a red automobile", "red car"],
        ["the dog is on the table"], ["xe màu xanh lá", "xe đạp"],
        ["không"]]


@pytest.mark.parametrize("name,args", [
    ("BLEUScore", ()), ("BLEUScore", (2,)), ("METEORScore", ()),
    ("ROUGEScore", ()), ("CIDErScore", ()), ("CIDErScore", (4, 6.0, "paper")),
    ("ExactMatchAccuracy", ()), ("PrecisionRecallF1", ()), ("WUPS", (0.9,)),
    ("WUPS", (0.0,))], ids=str)
def test_text_metrics_match_jax_exactly(name, args):
    """The generative pipeline's six metrics (and WUPS) on the same
    predictions and references, updated in two batches: values, metadata
    and per-sample scores identical."""
    got, want = getattr(PM, name)(*args), getattr(JM, name)(*args)
    for metric in (got, want):
        metric.update(PREDS[:5], REFS[:5])
        metric.update(PREDS[5:], REFS[5:])
    assert asdict(got.compute()) == asdict(want.compute())


def test_classification_metrics_match_jax_exactly():
    rs = np.random.RandomState(2)
    logits = rs.standard_normal((12, 7))
    labels = rs.randint(0, 7, 12)
    preds = logits.argmax(-1)
    counts = [{int(labels[i]): 2, 3: 1} for i in range(12)]
    questions = ["màu gì", "bao nhiêu con", "ở đâu", "ai vậy", "what is it",
                 "có phải không"] * 2
    for metric in ("create_classification_metrics",
                   "create_generative_metrics"):
        assert sorted(getattr(PM, metric)().metrics) == sorted(
            getattr(JM, metric)().metrics)
    cases = [("VQAAccuracy", (), (preds, counts)),
             ("VQASoftAccuracy", (), (preds, counts)),
             ("TopKAccuracy", (3,), (logits, labels)),
             ("F1Score", ("macro",), (preds, labels)),
             ("F1Score", ("micro",), (preds, labels)),
             ("F1Score", ("weighted",), (preds, labels)),
             ("AnswerTypeAccuracy", (), (preds, labels, questions))]
    for name, args, inputs in cases:
        got, want = getattr(PM, name)(*args), getattr(JM, name)(*args)
        got.update(*inputs)
        want.update(*inputs)
        assert asdict(got.compute()) == asdict(want.compute()), name
    assert [PM.normalize_answer(p) for p in PREDS] == [
        JM.normalize_answer(p) for p in PREDS]


# -- pipeline helpers --------------------------------------------------------
def test_early_stopping_and_param_count_match_jax(pairs):
    values = [0.1, 0.3, 0.3, 0.2, 0.5, 0.4, 0.4, 0.4]
    for kw in ({}, {"mode": "min", "patience": 2},
               {"min_delta": 0.05, "patience": 3}):
        got, want = PCommon.EarlyStopping(**kw), JCommon.EarlyStopping(**kw)
        assert [got.update(v) for v in values] == [want.update(v)
                                                   for v in values]
        assert (got.best, got.counter, got.should_stop) == (
            want.best, want.counter, want.should_stop)
    _, params, model = pairs("float32")
    assert PCommon.count_parameters(model) == JCommon.count_parameters(params)


# -- checkpoint manager ------------------------------------------------------
@pytest.mark.parametrize("kw,saves", [
    ({"best_mode": "max"}, [(2, 0.1), (4, 0.5), (6, 0.3), (8, 0.2),
                            (10, 0.6)]),
    ({"best_mode": "min"}, [(1, 0.3), (2, 0.3), (3, None), (4, 0.5),
                            (3, 0.1)]),
    ({"keep_best": False, "max_to_keep": 2},
     [(1, 0.3), (2, 0.2), (3, None), (5, 0.9)])], ids=str)
def test_checkpoint_retention_matches_orbax(kw, saves):
    """One short sequence of saves through the port's manager and the
    JAX package's orbax one: what each save returns (a step not past the
    latest is refused), the kept steps, best_step and latest_step after
    every save, restore_best's state and metadata, and a second manager
    opened over the same directory."""
    cfg = {"max_to_keep": 2, "best_metric": "bleu", **kw}
    results = {}
    for name, cls, cfg_cls in (("port", CheckpointManager, CheckpointConfig),
                               ("jax", JCkpt, JCkptCfg)):
        d = tempfile.mkdtemp()
        mgr = cls(cfg_cls(directory=d, **cfg))
        trace = []
        for step, metric in saves:
            state = {"w": np.full(3, float(step), np.float32)}
            if name == "port":
                state = {"w": torch.from_numpy(state["w"])}
            ok = mgr.save(step, state, metadata={"epoch": step},
                          metrics=None if metric is None
                          else {"bleu": metric})
            trace.append((ok, mgr.all_steps(), mgr.best_step(),
                          mgr.latest_step()))
        best, meta = mgr.restore_best()
        again = cls(cfg_cls(directory=d, **cfg))
        trace.append((again.all_steps(), again.best_step(),
                      again.latest_step()))
        if name == "jax":
            mgr.close()
            again.close()
        results[name] = (trace, np.asarray(best["w"]).tolist(), meta)
    assert results["port"] == results["jax"]


# -- the pipeline, end to end on the CPU -------------------------------------
WORDS = ["màu", "gì", "vậy", "có", "bao", "nhiêu", "con", "mèo", "chó",
         "đỏ", "xanh", "hai", "ba", "trên", "bàn", "không"]


def _pipeline_setup(seed: int = 0):
    """The tiny model with the tokenizer's ids, and loaders of collated
    batches: 2 train batches of 3 and one validation batch of 3."""
    tok = PTok(max_length=8)
    tok.build_vocab(WORDS)
    cfg = gen_config(PC, vocab_size=tok.vocab_size, bos_token_id=2,
                     eos_token_id=3, pad_token_id=0)
    model = create_generative_vqa_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(5)
    samples = [PSample(rs.randint(0, 256, (32, 32, 3), dtype=np.uint8),
                       " ".join(rs.choice(WORDS, rs.randint(2, 9))),
                       [" ".join(rs.choice(WORDS, rs.randint(1, 5)))])
               for _ in range(9)]
    ds = PD.GenerativeVQADataset(samples, tok, PAug(32, mode="eval"),
                                 max_question_length=8, max_answer_length=6)
    batches = [PD.generative_collate([ds[i] for i in range(j, j + 3)])
               for j in (0, 3, 6)]
    return model, tok, batches[:2], batches[2:]


def _run(tmp_path, model, tok, train, val, **kw):
    cfg = GenerativeTrainingConfig(
        checkpoint_dir=str(tmp_path), log_every=1,
        optimizer=PO.OptimizerConfig(learning_rate=1e-3), **kw)
    return GenerativeTrainingPipeline(cfg).run(model, train, val, tok)


HISTORY_KEYS = {"bleu", "meteor", "rouge_l", "cider", "exact_match",
                "token_f1", "train_loss", "epoch", "perplexity",
                "tokens_per_sec"}


def test_pipeline_trains_validates_and_saves_on_improvement(tmp_path):
    """Two epochs of two steps under onecycle: the history's keys and
    finite values, a checkpoint at each epoch whose metric improved
    (the first always), restore_best giving back the saved parameters."""
    model, tok, train, val = _pipeline_setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = _run(tmp_path, model, tok, train, val, num_epochs=2)
    assert [h["epoch"] for h in out.history] == [0, 1]
    for h in out.history:
        assert set(h) == HISTORY_KEYS
        assert all(np.isfinite(v) for v in h.values())
        assert h["tokens_per_sec"] > 0
    assert out.state.step == 4 and out.final_metrics == out.history[-1]
    improved = [0] + ([1] if out.history[1]["bleu"] > out.history[0]["bleu"]
                      else [])
    ckpt = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                              best_metric="bleu"))
    assert ckpt.all_steps() == [2 * (e + 1) for e in improved]
    assert out.best_metric == max(h["bleu"] for h in out.history)
    params, meta = ckpt.restore_best()
    assert meta["epoch"] == improved[-1]
    assert meta["metrics"] == {"bleu": out.best_metric}
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    if improved[-1] == 1:                  # the last epoch's parameters
        for n, p in model.named_parameters():
            assert torch.equal(params["params"][n], p.detach()), n


def test_pipeline_stops_early_and_resumes_at_the_next_epoch(tmp_path):
    """A metric that never improves (one no metric provides reads 0.0)
    stops the run after ``patience`` epochs with one checkpoint; resume
    restores it and continues at its epoch + 1 with a fresh optimizer."""
    model, tok, train, val = _pipeline_setup()
    out = _run(tmp_path, model, tok, train, val, num_epochs=4,
               early_stopping_patience=1, metric_for_best="missing")
    assert [h["epoch"] for h in out.history] == [0, 1]
    ckpt = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                              best_metric="missing"))
    assert ckpt.all_steps() == [2]
    saved, meta = ckpt.restore_best()
    assert meta["epoch"] == 0

    other, *_ = _pipeline_setup(seed=1)
    _run(tmp_path, other, tok, train, val, num_epochs=1, resume=True,
         metric_for_best="missing")       # epoch 0 done: nothing to run
    for n, p in other.named_parameters():
        assert torch.equal(p.detach(), saved["params"][n]), n
    out = _run(tmp_path, other, tok, train, val, num_epochs=2, resume=True,
               metric_for_best="missing")
    assert [h["epoch"] for h in out.history] == [1]
    assert out.state.step == 2 and out.state.optimizer.count == 2


def test_pipeline_refuses_unported_strategies(tmp_path):
    """Every strategy is ported (the name is kept from when they raised):
    the pipeline applies epoch 0's mask for the whole run, as the JAX
    pipeline does, so under gradual_unfreeze both encoders stay frozen
    through both epochs while the fusion and decoder train; an unknown
    strategy raises."""
    model, tok, train, val = _pipeline_setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _run(tmp_path, model, tok, train, val, num_epochs=2,
         strategy="gradual_unfreeze")
    for n, p in model.named_parameters():
        frozen = n.startswith(("visual_encoder", "question_encoder"))
        assert torch.equal(p.detach(), before[n]) == frozen, n
    with pytest.raises(ValueError, match="unknown strategy"):
        _run(tmp_path / "x", model, tok, train, val, strategy="freeze_all")
