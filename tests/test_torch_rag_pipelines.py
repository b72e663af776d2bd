"""Both CLIs with ``--use-knowledge`` against the JAX package's, on the CPU
(as tests/test_pipelines.py:240-300 runs the JAX ones: the
classification pipeline with the hybrid retriever, the generative one
with the sparse one; the knowledge base built from the training split's
QA pairs, or read from ``--kb-path``).

One JAX init with the knowledge leaves is carried across: saved as an
orbax checkpoint and, through the weight bridge, as a port checkpoint;
each side's CLI (``main([...])`` with a YAML config and the knowledge
flags) trains two epochs resuming from its own. Classification: the
predictions, every metric but the losses and the best step equal, the
losses within 1% (the bf16 MCAN, ROADMAP.md Queue C); evaluate (which
passes the knowledge arrays) and inference (which, through
``VQAPredictor``, does not: the JAX package's behaviour, kept) from the
trained checkpoint equal. Generative (f32): the losses to 1e-4 relative,
the decoded strings and so every metric equal, in train, evaluate
(greedy and beam) and inference from the init.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_support import kept_prng_impl
from vivqa_tpu.knowledge import KnowledgeProviderConfig as JKCfg
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu.parallel import MeshConfig
from vivqa_tpu.parallel import create_mesh as j_create_mesh
from vivqa_tpu.pipelines import data_pipeline as JDP
from vivqa_tpu.pipelines import generative_training_pipeline as JGT
from vivqa_tpu.pipelines import generative_vqa_pipeline as JGP
from vivqa_tpu.pipelines import model_pipeline as JMP
from vivqa_tpu.pipelines import training_pipeline as JTP
from vivqa_tpu.pipelines import vqa_pipeline as JVP
from vivqa_tpu.train import OptimizerConfig as JOpt
from vivqa_tpu.train.checkpoint import CheckpointConfig as JCkptConfig
from vivqa_tpu.train.checkpoint import CheckpointManager as JCkpt
from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.knowledge import KnowledgeProviderConfig as PKCfg
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import load_flax_params
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.pipelines import data_pipeline as PDP
from vivqa_tpu_torch.pipelines import generative_training_pipeline as PGT
from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as PGP
from vivqa_tpu_torch.pipelines import model_pipeline as PMP
from vivqa_tpu_torch.pipelines import training_pipeline as PTP
from vivqa_tpu_torch.pipelines import vqa_pipeline as PVP
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager)
from vivqa_tpu_torch.train.optimizers import OptimizerConfig as POpt

torch.set_num_threads(1)

N, S, BATCH, EPOCHS, K, KDIM = 32, 16, 8, 2, 3, 32
CLS_LOSS_RTOL = 1e-2          # the bf16 MCAN and head (module docstring)
GEN_LOSS_RTOL = SCORE_TOL = 1e-4
NOT_PREDICTIONS = ("val_loss", "train_loss", "qa_pairs_per_sec")
NOT_STRINGS = ("train_loss", "perplexity", "tokens_per_sec")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("rag_corpus")
    cls = generate_synthetic_vivqa(d / "cls", n=N, image_size=S,
                                   learnable=True)
    gen = generate_synthetic_vivqa(d / "gen", n=N, image_size=S,
                                   learnable=True, seq_answers=True)
    return [str(p) for p in cls], [str(p) for p in gen]


@contextlib.contextmanager
def _one_device():
    """The JAX pipelines on a one-device mesh, as their own tests run
    them, with the PRNG implementation that their ``set_seed`` switches
    restored after them."""
    one = lambda c: j_create_mesh(c, devices=jax.devices("cpu")[:1])
    with pytest.MonkeyPatch.context() as mp, kept_prng_impl():
        mp.setattr(JMP, "create_mesh", one)
        mp.setattr(JGP, "create_mesh", one)
        yield


def _save_init(tmp, params, meta, port_model):
    """The init as the JAX package's orbax checkpoint and as the port's."""
    mgr = JCkpt(JCkptConfig(directory=str(tmp / "init_jax")))
    mgr.save(0, {"params": params}, metadata=meta)
    mgr.close()
    port = load_flax_params(port_model, params)
    CheckpointManager(CheckpointConfig(directory=str(tmp / "init_port"))
                      ).save(0, {"params": dict(port.named_parameters())},
                             metadata=meta)
    return str(tmp / "init_jax"), str(tmp / "init_port")


# -- classification -----------------------------------------------------------
def _cls_model(mod, vocab=0, answers=1000, knowledge_dim=512):
    """tests/test_torch_pipelines.py's tiny model (MCAN, f32 where the
    config reaches, every dropout 0) with K = 3 contexts; the knowledge
    flag comes from the command line."""
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(image_size=S, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype="float32"),
        text=mod.TextEncoderConfig(vocab_size=vocab or 30000,
                                   hidden_dim=32, num_layers=1, num_heads=2,
                                   max_length=8, dropout=0.0,
                                   dtype="float32"),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=0.0),
        knowledge=mod.KnowledgeModelConfig(num_retrieved=K,
                                           knowledge_dim=knowledge_dim),
        head=mod.AnswerHeadConfig(dropout=0.0), num_answers=answers,
        dtype="float32")


def _cls_yaml(tmp, side, csv, imgs, init):
    if side == "jax":
        dp, mp, tp, vp, opt, kc = JDP, JMP, JTP, JVP, JOpt, JKCfg
        model = mp.ModelPipelineConfig(model=_cls_model(JC),
                                       mesh=MeshConfig(model_axis=1))
    else:
        dp, mp, tp, vp, opt, kc = PDP, PMP, PTP, PVP, POpt, PKCfg
        model = mp.ModelPipelineConfig(model=_cls_model(PC))
    cfg = vp.VQAPipelineConfig(
        data=dp.DataPipelineConfig(
            csv_path=csv, image_dir=imgs, image_size=S,
            max_question_length=8, batch_size=BATCH,
            augmentation_strength="light"),
        model=model,
        training=tp.TrainingPipelineConfig(
            num_epochs=EPOCHS, optimizer=opt(learning_rate=5e-3),
            checkpoint_dir=str(tmp / f"ck_{side}"),
            early_stopping_patience=10, log_every=1),
        knowledge=kc(retriever="hybrid", encoder_dim=KDIM),
        output_dir=str(tmp / f"out_{side}"), resume=init)
    path = tmp / f"cls_{side}.yaml"
    cfg.to_yaml(path)
    return str(path)


@pytest.fixture(scope="module")
def cls_runs(corpora, tmp_path_factory):
    (csv, imgs), _ = corpora
    tmp = tmp_path_factory.mktemp("rag_cls")
    data = JDP.DataPipeline(JDP.DataPipelineConfig(
        csv_path=csv, image_dir=imgs, image_size=S, max_question_length=8,
        batch_size=BATCH)).run()
    vocab, answers = data.tokenizer.vocab_size, len(data.answer2id)
    jm = JModel(_cls_model(JC, vocab, answers, KDIM).replace(
        knowledge=_cls_model(JC).knowledge.replace(use_knowledge=True,
                                                   knowledge_dim=KDIM)))
    b = next(iter(data.val_loader))
    key = jax.random.PRNGKey(0)
    params = jax.device_get(jax.jit(jm.init)(
        {"params": key, "router": key}, b["pixel_values"], b["input_ids"],
        b["attention_mask"], np.zeros((BATCH, K, KDIM), np.float32),
        np.ones((BATCH, K), np.int32))["params"])
    jinit, pinit = _save_init(tmp, params, {"num_answers": answers},
                              VietnameseVQAModel(_cls_model(
                                  PC, vocab, answers, KDIM).replace(
                                  knowledge=PC.KnowledgeModelConfig(
                                      use_knowledge=True, num_retrieved=K,
                                      knowledge_dim=KDIM))))
    jyaml = _cls_yaml(tmp, "jax", csv, imgs, jinit)
    pyaml = _cls_yaml(tmp, "port", csv, imgs, pinit)
    out = {"tmp": tmp, "answers": answers}
    for mode, argv in (("train", []),
                       ("evaluate", ["--resume", str(tmp / "ck_{}")]),
                       ("inference", ["--resume", str(tmp / "ck_{}")])):
        with _one_device():
            out[f"jax_{mode}"] = JVP.main(
                ["--config", jyaml, "--mode", mode, "--use-knowledge"]
                + [a.format("jax") for a in argv])
        out[f"port_{mode}"] = PVP.main(
            ["--config", pyaml, "--mode", mode, "--use-knowledge",
             "--device", "cpu"] + [a.format("port") for a in argv])
        for side in ("jax", "port"):
            if mode == "inference":
                out[f"{side}_predictions"] = json.loads(
                    (tmp / f"out_{side}" / "inference_results.json")
                    .read_text())
    for side in ("jax", "port"):
        mgr = (JCkpt if side == "jax" else CheckpointManager)(
            (JCkptConfig if side == "jax" else CheckpointConfig)(
                directory=str(tmp / f"ck_{side}")))
        out[f"{side}_best"] = mgr.best_step()
    return out


def _assert_same_predictions(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k not in NOT_PREDICTIONS:
            assert got[k] == w, (k, got[k], w)


def test_classification_cli_knowledge_train_matches_jax(cls_runs):
    """Two epochs of ``--use-knowledge`` training from one init: each
    epoch's predictions (every metric), the best step and metric, and the
    final evaluation equal; the losses within 1%."""
    jt, pt = cls_runs["jax_train"], cls_runs["port_train"]
    assert len(pt["history"]) == len(jt["history"]) == EPOCHS
    for j, p in zip(jt["history"], pt["history"]):
        _assert_same_predictions(p, j)
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(p[k], j[k], rtol=CLS_LOSS_RTOL,
                                       err_msg=k)
    _assert_same_predictions(pt["final_metrics"], jt["final_metrics"])
    assert pt["best_metric"] == jt["best_metric"]
    assert cls_runs["port_best"] == cls_runs["jax_best"] is not None
    assert pt["config"]["model"]["model"]["knowledge"]["use_knowledge"]
    assert pt["history"][-1]["train_loss"] < pt["history"][0]["train_loss"]


def test_classification_cli_knowledge_evaluate_and_inference_match_jax(
        cls_runs):
    """evaluate gives the JAX package's metrics (its validation passes
    the knowledge arrays); inference the same answers and confidences
    (``VQAPredictor`` calls the model without them, in both packages)."""
    jev, pev = cls_runs["jax_evaluate"], cls_runs["port_evaluate"]
    _assert_same_predictions(pev["metrics"], jev["metrics"])
    np.testing.assert_allclose(pev["metrics"]["val_loss"],
                               jev["metrics"]["val_loss"],
                               rtol=CLS_LOSS_RTOL)
    got, want = cls_runs["port_predictions"], cls_runs["jax_predictions"]
    assert len(got) == len(want) == cls_runs["port_inference"][
        "num_predictions"] > 0
    for g, w in zip(got, want):
        assert (g["question"], g["answer"]) == (w["question"], w["answer"])
        assert [a for a, _ in g["top_answers"]] == \
            [a for a, _ in w["top_answers"]]
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   rtol=CLS_LOSS_RTOL)


def test_classification_inference_skips_the_knowledge_branch(cls_runs):
    """The quirk kept from the JAX package (ROADMAP.md Queue C): inference
    answers from the model's forward without knowledge; the trained
    checkpoint's knowledge weights are loaded, but unused there."""
    from vivqa_tpu_torch.eval.predictor import VQAPredictor
    tmp = cls_runs["tmp"]
    cfg = PVP.VQAPipelineConfig.from_yaml(tmp / "cls_port.yaml")
    data = PDP.DataPipeline(cfg.data).run()
    mc = cfg.model.model.replace(
        text=cfg.model.model.text.replace(
            vocab_size=data.tokenizer.vocab_size),
        knowledge=cfg.model.model.knowledge.replace(use_knowledge=True,
                                                    knowledge_dim=KDIM))
    out, _ = PMP.ModelPipeline(cfg.model.replace(
        model=mc, device="cpu")).load_checkpoint(str(tmp / "ck_port"))
    pred = VQAPredictor(out.model, data.tokenizer, data.id2answer,
                        image_size=S, device="cpu")
    sample = data.test_loader.dataset.samples[0]
    batch = next(iter(data.test_loader))
    r = pred.predict_arrays(batch["pixel_values"][0], sample.question)
    assert r.answer == cls_runs["port_predictions"][0]["answer"]
    enc = data.tokenizer.encode_batch([sample.question], 8)
    with torch.no_grad():
        plain = out.model(torch.from_numpy(batch["pixel_values"][:1]),
                          torch.from_numpy(enc["input_ids"]).long(),
                          torch.from_numpy(enc["attention_mask"]).long())
    assert data.id2answer[int(plain["logits"].argmax())] == r.answer


# -- generative ----------------------------------------------------------------
def _gen_model(mod):
    return mod.GenerativeVQAConfig(
        visual=mod.VisualEncoderConfig(image_size=S, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype="float32"),
        text=mod.TextEncoderConfig(vocab_size=512, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dropout=0.0, dtype="float32"),
        fusion_dim=32, fusion_layers=1, fusion_heads=2, decoder_layers=1,
        decoder_heads=2, decoder_dim=32, decoder_ff_dim=64, dropout=0.0,
        knowledge=mod.KnowledgeModelConfig(num_retrieved=K),
        dtype="float32")


def _gen_yaml(tmp, side, csv, imgs, kb_path):
    if side == "jax":
        dp, gt, gp, opt, kc = JDP, JGT, JGP, JOpt, JKCfg
        extra = {"mesh": MeshConfig(model_axis=1)}
    else:
        dp, gt, gp, opt, kc = PDP, PGT, PGP, POpt, PKCfg
        extra = {"device": "cpu"}
    cfg = gp.GenerativeVQAPipelineConfig(
        data=dp.DataPipelineConfig(
            csv_path=csv, image_dir=imgs, image_size=S,
            max_question_length=8, max_answer_length=6, batch_size=BATCH,
            augmentation_strength="light", generative=True),
        model=_gen_model(JC if side == "jax" else PC),
        training=gt.GenerativeTrainingConfig(
            num_epochs=EPOCHS, optimizer=opt(learning_rate=1e-2),
            checkpoint_dir=str(tmp / f"ck_{side}"),
            early_stopping_patience=10, log_every=1),
        knowledge=kc(retriever="sparse", encoder_dim=KDIM, kb_path=kb_path),
        output_dir=str(tmp / f"out_{side}"), **extra)
    path = tmp / f"gen_{side}.yaml"
    cfg.to_yaml(path)
    return str(path)


@pytest.fixture(scope="module")
def gen_runs(corpora, tmp_path_factory):
    """The generative CLI with ``--use-knowledge`` and
    ``--retriever-top-k 2`` (which the model's K overrides, in both
    packages), the knowledge base from the training QA pairs for train
    and from a JSON file for evaluate and inference."""
    _, (csv, imgs) = corpora
    tmp = tmp_path_factory.mktemp("rag_gen")
    kb = tmp / "kb.json"
    kb.write_text(json.dumps(
        [{"content": c, "category": "fact"} for c in (
            "con mèo màu đen", "có hai con chó", "quả táo màu đỏ",
            "người đàn ông đang đi xe máy", "bầu trời màu xanh")],
        ensure_ascii=False))
    argv = ["--use-knowledge", "--retriever-top-k", "2"]
    jyaml = _gen_yaml(tmp, "jax", csv, imgs, "")
    with _one_device():
        _, jm, params, _ = JGP.GenerativeVQAPipeline(
            JGP.GenerativeVQAPipelineConfig.from_yaml(jyaml).replace(
                model=JGP.GenerativeVQAPipelineConfig.from_yaml(
                    jyaml).model.replace(knowledge=JC.KnowledgeModelConfig(
                        use_knowledge=True, num_retrieved=K))))._setup()
    params = jax.device_get(params)
    meta = {"epoch": -1, "config": jm.config.to_dict()}
    jinit, pinit = _save_init(tmp, params, meta, GenerativeVQAModel(
        PC.GenerativeVQAConfig.from_dict(meta["config"])))
    out = {"tmp": tmp, "knowledge_dim": jm.config.knowledge.knowledge_dim}
    pyaml = _gen_yaml(tmp, "port", csv, imgs, "")
    runs = [("train", ["--resume", "{init}"], ""),
            ("greedy", ["--mode", "evaluate", "--resume", "{init}"],
             str(kb)),
            ("beam", ["--mode", "evaluate", "--resume", "{init}",
                      "--decode", "beam", "--num-beams", "4"], str(kb)),
            ("inference", ["--mode", "inference", "--resume", "{init}"],
             str(kb))]
    for name, extra, kb_path in runs:
        kbargs = ["--kb-path", kb_path] if kb_path else []
        with _one_device():
            out[f"jax_{name}"] = JGP.main(
                ["--config", jyaml] + argv + kbargs
                + [a.format(init=jinit) for a in extra])
        out[f"port_{name}"] = PGP.main(
            ["--config", pyaml] + argv + kbargs
            + [a.format(init=pinit) for a in extra])
    return out


def test_generative_cli_knowledge_train_matches_jax(gen_runs):
    """Two epochs from one init: train losses to 1e-4 relative, every
    metric of the decoded strings equal; K is the model's 3, not the
    flag's 2, on both sides."""
    jh, ph = gen_runs["jax_train"]["history"], \
        gen_runs["port_train"]["history"]
    assert len(jh) == len(ph) == EPOCHS
    for j, p in zip(jh, ph):
        assert sorted(p) == sorted(j)
        for k in ("train_loss", "perplexity"):
            np.testing.assert_allclose(p[k], j[k], rtol=GEN_LOSS_RTOL,
                                       err_msg=k)
        for k, v in j.items():
            if k not in NOT_STRINGS:
                assert p[k] == v, (k, p[k], v)
    cfg = gen_runs["port_train"]["config"]
    assert cfg["knowledge"]["num_retrieved"] == 2
    assert cfg["model"]["knowledge"]["num_retrieved"] == K
    assert gen_runs["knowledge_dim"] == KDIM


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_generative_cli_knowledge_evaluate_matches_jax(gen_runs, strategy):
    got, want = gen_runs[f"port_{strategy}"], gen_runs[f"jax_{strategy}"]
    assert got["metrics"] == want["metrics"]


def test_generative_cli_knowledge_inference_matches_jax(gen_runs):
    got = json.loads(Path(gen_runs["port_inference"]["results_path"])
                     .read_text())
    want = json.loads(Path(gen_runs["jax_inference"]["results_path"])
                      .read_text())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["question"], g["generated_answer"], g["references"]) == \
            (w["question"], w["generated_answer"], w["references"])
        assert g["score"] == pytest.approx(w["score"], rel=SCORE_TOL,
                                           abs=SCORE_TOL)
    assert any(g["generated_answer"] for g in got)


def test_generative_cli_knowledge_batches_reach_the_model(corpora,
                                                          tmp_path):
    """The pipeline's loaders carry (B, K, dim) f32 embeddings and a
    (B, K) int32 mask; the model built for them appends K memory tokens,
    and the generate with them differs from the one without."""
    _, (csv, imgs) = corpora
    cfg = PGP.GenerativeVQAPipelineConfig.from_yaml(
        _gen_yaml(tmp_path, "port", csv, imgs, ""))
    cfg = cfg.replace(model=cfg.model.replace(
        knowledge=cfg.model.knowledge.replace(use_knowledge=True)))
    pipe = PGP.GenerativeVQAPipeline(cfg)
    data, model = pipe._setup()
    batch = next(iter(data.val_loader))
    assert batch["knowledge_embeddings"].shape == (BATCH, K, KDIM)
    assert batch["knowledge_embeddings"].dtype == np.float32
    assert batch["knowledge_mask"].shape == (BATCH, K)
    assert batch["knowledge_mask"].dtype == np.int32
    dev = PGT.batch_to_device(batch, torch.device("cpu"))
    assert dev["knowledge_mask"].dtype == torch.int64
    with torch.no_grad():
        enc = model.encode(dev["pixel_values"], dev["question_ids"],
                           dev["question_mask"],
                           knowledge_embeddings=dev["knowledge_embeddings"],
                           knowledge_mask=dev["knowledge_mask"])
    assert enc["memory"].shape[1] == (S // 8) ** 2 + 8 + K
    assert torch.equal(enc["memory_mask"][:, -K:], dev["knowledge_mask"])
