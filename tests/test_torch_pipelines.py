"""The port's classification pipeline stack against the JAX package, on
the CPU: ``TrainingPipeline`` for two epochs from the same JAX init
(losses, metric dicts, best step, final evaluation on the best
checkpoint), the evaluator, the result manager, the model pipeline's
checkpoint loading, the mid-run resume, ``VQAPipeline`` train ->
evaluate -> inference through ``main([...])``, the command line against
the JAX package's flag by flag, the config helpers, and the paths that
name a ROADMAP item instead of running.

The tiny model is the flagship's structure at image 16, dim 32, one
layer, MCAN fusion, no MoE (JAX's MoE experts always drop at 0.1 when
training), dropout 0 everywhere (the JAX loss runs deterministic=False),
f32 where the config reaches: MCAN and the answer head's hidden layer
compute in bf16 in both packages by design (``fusion/mcan.py``,
``heads.py``), and the two frameworks round their bf16 attention at other
points (ROADMAP.md Queue C), so losses agree to a bf16 rounding, not to
f32's."""

from __future__ import annotations

import ast
import dataclasses
import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_support import kept_prng_impl
from vivqa_tpu.eval.evaluator import VQAEvaluator as JEvaluator
from vivqa_tpu.eval.predictor import PredictionResult as JResult
from vivqa_tpu.eval.result_manager import InferenceResultManager as JRM
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu.parallel import MeshConfig, create_mesh
from vivqa_tpu.pipelines import common as JCOMMON
from vivqa_tpu.pipelines import data_pipeline as JDP
from vivqa_tpu.pipelines import model_pipeline as JMP
from vivqa_tpu.pipelines import training_pipeline as JTP
from vivqa_tpu.pipelines import vqa_pipeline as JVP
from vivqa_tpu.train import OptimizerConfig as JOpt
from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.eval.evaluator import EvaluatorConfig, VQAEvaluator
from vivqa_tpu_torch.eval.predictor import PredictionResult
from vivqa_tpu_torch.eval.result_manager import InferenceResultManager
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import load_flax_params
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.pipelines import common as PCOMMON
from vivqa_tpu_torch.pipelines import data_pipeline as PDP
from vivqa_tpu_torch.pipelines import model_pipeline as PMP
from vivqa_tpu_torch.pipelines import training_pipeline as PTP
from vivqa_tpu_torch.pipelines import vqa_pipeline as PVP
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager, partial_load)
from vivqa_tpu_torch.train.optimizers import OptimizerConfig as POpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EPOCHS, LR = 2, 5e-3
# the bf16 MCAN and head round at other points in the two frameworks
# (the module docstring): 0.3% measured on the losses here; held to 1%,
# the per-step loss tolerance of tests/test_torch_train.py
LOSS_RTOL = 1e-2
# values that are not functions of the predictions: the losses (above)
# and the host clock's throughput
NOT_PREDICTIONS = ("val_loss", "train_loss", "qa_pairs_per_sec")


def _model_config(mod, vocab: int, answers: int):
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(backbone="clip", image_size=16,
                                       patch_size=8, hidden_dim=32,
                                       num_layers=1, num_heads=2,
                                       dtype="float32"),
        text=mod.TextEncoderConfig(backbone="phobert", vocab_size=vocab,
                                   hidden_dim=32, num_layers=1, num_heads=2,
                                   max_length=8, dropout=0.0,
                                   dtype="float32"),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=0.0),
        head=mod.AnswerHeadConfig(dropout=0.0),
        num_answers=answers, dtype="float32")


def _data_config(mod, csv, imgs):
    return mod.DataPipelineConfig(
        csv_path=csv, image_dir=imgs, image_size=16, max_question_length=8,
        batch_size=8, augmentation_strength="light")


def _training_config(mod, opt, directory, epochs=EPOCHS, **kw):
    return mod.TrainingPipelineConfig(
        num_epochs=epochs, optimizer=opt(learning_rate=LR),
        checkpoint_dir=str(directory), early_stopping_patience=10,
        log_every=1, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    csv, imgs = generate_synthetic_vivqa(d, n=32, image_size=16,
                                         learnable=True)
    return str(csv), str(imgs)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both packages' DataPipeline and TrainingPipeline, two epochs from
    one JAX init (a one-device mesh: plain jit)."""
    with kept_prng_impl():
        return _runs(corpus, tmp_path_factory)


def _runs(corpus, tmp_path_factory):
    csv, imgs = corpus
    jdata = JDP.DataPipeline(_data_config(JDP, csv, imgs)).run()
    pdata = PDP.DataPipeline(_data_config(PDP, csv, imgs)).run()
    vocab, answers = pdata.tokenizer.vocab_size, len(pdata.answer2id)
    jm = JModel(_model_config(JC, vocab, answers))
    b = next(iter(jdata.val_loader))
    key = jax.random.PRNGKey(0)
    params = jax.device_get(jax.jit(jm.init)(
        {"params": key, "router": key}, b["pixel_values"], b["input_ids"],
        b["attention_mask"])["params"])
    model = load_flax_params(
        VietnameseVQAModel(_model_config(PC, vocab, answers)), params)
    mesh = create_mesh(MeshConfig(), devices=jax.devices("cpu")[:1])
    jdir = tmp_path_factory.mktemp("ck_jax")
    pdir = tmp_path_factory.mktemp("ck_port")
    jout = JTP.TrainingPipeline(_training_config(JTP, JOpt, jdir)).run(
        jm, params, mesh, jdata.train_loader, jdata.val_loader,
        jdata.id2answer)
    pout = PTP.TrainingPipeline(_training_config(PTP, POpt, pdir)).run(
        model, pdata.train_loader, pdata.val_loader, pdata.id2answer)
    return dict(jdata=jdata, pdata=pdata, jm=jm, jout=jout, pout=pout,
                model=model, pdir=pdir, vocab=vocab, answers=answers)


def _assert_metrics_match(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in NOT_PREDICTIONS:
            continue
        assert got[k] == w, (k, got[k], w)


# -- TrainingPipeline against JAX -------------------------------------------
def test_training_losses_match_jax(runs):
    """Per-epoch train and validation losses within LOSS_RTOL."""
    jh, ph = runs["jout"].history, runs["pout"].history
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1]
    for j, p in zip(jh, ph):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {j['epoch']} {k}")
    assert ph[-1]["train_loss"] < ph[0]["train_loss"]


def test_training_metrics_and_best_step_match_jax(runs):
    """The same predictions each epoch, so the same metric dicts, the same
    best step and best metric, and the final evaluation on the reloaded
    best checkpoint."""
    jout, pout = runs["jout"], runs["pout"]
    for j, p in zip(jout.history, pout.history):
        _assert_metrics_match(p, j)
        assert p["qa_pairs_per_sec"] > 0
    assert pout.best_step == jout.best_step is not None
    assert pout.best_metric == jout.best_metric
    _assert_metrics_match(pout.final_metrics, jout.final_metrics)
    np.testing.assert_allclose(pout.final_metrics["val_loss"],
                               jout.final_metrics["val_loss"],
                               rtol=LOSS_RTOL)


def test_training_step_times(runs):
    """The run times its own loop: per epoch one host time per step (the
    wait for the batch included) and the loop's time to the epoch's loss
    read, which holds them all."""
    pout, pdata = runs["pout"], runs["pdata"]
    steps = len(pdata.train_loader)
    assert [len(e) for e in pout.step_seconds] == [steps] * EPOCHS
    for epoch, loop in zip(pout.step_seconds, pout.loop_seconds):
        assert all(t > 0 for t in epoch) and sum(epoch) <= loop


def test_checkpoint_metadata_and_reload(runs):
    """The best checkpoint holds num_answers, the vocabulary with string
    keys and the epoch; ModelPipeline.load_checkpoint rebuilds the model
    from it (num_answers from the metadata) and its validation equals the
    pipeline's final evaluation exactly."""
    pdata, pout = runs["pdata"], runs["pout"]
    ckpt = CheckpointManager(CheckpointConfig(directory=str(runs["pdir"])))
    _, meta = ckpt.restore_best()
    assert meta["num_answers"] == runs["answers"]
    assert meta["vocabulary"] == {str(k): v
                                  for k, v in pdata.id2answer.items()}
    assert meta["epoch"] in (0, 1)
    assert ckpt.best_step() == pout.best_step
    pipe = PMP.ModelPipeline(PMP.ModelPipelineConfig(
        model=_model_config(PC, runs["vocab"], 2), device="cpu"))
    out, meta2 = pipe.load_checkpoint(str(runs["pdir"]))
    assert meta2 == meta and out.model.config.num_answers == runs["answers"]
    got = PTP.TrainingPipeline(PTP.TrainingPipelineConfig()).validate(
        out.model, pdata.val_loader, pdata.id2answer)
    assert got == pout.final_metrics


def test_model_parameter_counts_match_jax(runs):
    params = jax.device_get(runs["jout"].state.params)
    assert PCOMMON.count_parameters(runs["model"]) == \
        JCOMMON.count_parameters(params)


def test_evaluator_matches_jax(runs, tmp_path):
    """VQAEvaluator on the JAX run's final (best) weights in both
    packages: metrics, per-question-type accuracy and confusions equal;
    the error examples' softmax confidences within 1% (the bf16 fusion),
    and save() writes the same JSON keys."""
    jdata, pdata = runs["jdata"], runs["pdata"]
    params = jax.device_get(runs["jout"].state.params)
    model = load_flax_params(VietnameseVQAModel(
        _model_config(PC, runs["vocab"], runs["answers"])), params)
    want = JEvaluator().evaluate(runs["jm"], params, jdata.test_loader,
                                 jdata.id2answer)
    ev = VQAEvaluator(EvaluatorConfig(output_dir=str(tmp_path)))
    got = ev.evaluate(model, pdata.test_loader, pdata.id2answer)
    assert got.metrics == want.metrics
    assert got.per_question_type == want.per_question_type
    assert got.num_samples == want.num_samples == 4
    ga, wa = got.error_analysis, want.error_analysis
    assert ga["top_confusions"] == wa["top_confusions"]
    assert len(ga["examples"]) == len(wa["examples"])
    for g, w in zip(ga["examples"], wa["examples"]):
        assert {k: g[k] for k in ("question", "gold", "pred")} == \
            {k: w[k] for k in ("question", "gold", "pred")}
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   rtol=1e-2)
    saved = json.loads(ev.save(got).read_text())
    assert sorted(saved) == sorted(dataclasses.asdict(want))


def test_training_pipeline_mid_run_resume(corpus, tmp_path):
    """resume=True continues an interrupted run from the best saved epoch
    with a fresh optimizer: the second chunk runs only the remaining
    epochs, from trained weights; its saves keep orbax's rule (a step
    not past the latest saved one is refused)."""
    csv, imgs = corpus
    data = PDP.DataPipeline(_data_config(PDP, csv, imgs)).run()
    mcfg = _model_config(PC, data.tokenizer.vocab_size, len(data.answer2id))

    def chunk(n):
        model = PMP.ModelPipeline(PMP.ModelPipelineConfig(
            model=mcfg, device="cpu")).run().model
        return PTP.TrainingPipeline(_training_config(
            PTP, POpt, tmp_path / "ck", epochs=n, resume=True)).run(
            model, data.train_loader, data.val_loader, data.id2answer)

    out1 = chunk(2)          # resume with an empty directory: from scratch
    assert [h["epoch"] for h in out1.history] == [0, 1]
    ckpt = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "ck")))
    before = ckpt.all_steps()
    # the epoch the best saved checkpoint holds (which of the two is best
    # follows the seeded init's training)
    best = ckpt.restore_best()[1]["epoch"]
    assert best in (0, 1)
    out2 = chunk(4)
    assert [h["epoch"] for h in out2.history] == list(range(best + 1, 4))
    assert out2.history[-1]["train_loss"] < out1.history[0]["train_loss"]
    assert all(s > before[-1] for s in set(ckpt.all_steps()) - set(before))
    assert out2.state.step == (3 - best) * len(data.train_loader)


# -- the CLI ----------------------------------------------------------------
def _write_config(path, csv, imgs, vocab, answers, out, ckpt):
    cfg = PVP.VQAPipelineConfig(
        data=_data_config(PDP, csv, imgs),
        model=PMP.ModelPipelineConfig(model=_model_config(PC, vocab,
                                                          answers)),
        training=_training_config(PTP, POpt, ckpt), output_dir=str(out))
    cfg.to_yaml(path)
    return cfg


def test_vqa_pipeline_cli_train_evaluate_inference(corpus, tmp_path):
    """python -m vivqa_tpu_torch.pipelines.vqa_pipeline, as main([...]):
    train, then evaluate and inference from the checkpoint, on the CPU;
    the summary, run stats and predictions are written as JAX writes
    them, one prediction per test sample."""
    csv, imgs = corpus
    out, ck = tmp_path / "out", tmp_path / "ck"
    yaml_path = tmp_path / "cfg.yaml"
    _write_config(yaml_path, csv, imgs, 50, 2, out, ck)
    base = ["--config", str(yaml_path), "--device", "cpu"]
    train = PVP.main(base + ["--mode", "train", "--epochs", "2"])
    assert len(train["history"]) == 2 and train["mode"] == "train"
    summary = json.loads((out / "pipeline_summary.json").read_text())
    assert summary["config"]["model"]["device"] == "cpu"
    assert summary["config"]["training"]["num_epochs"] == 2
    assert len(summary["step_seconds"]) == len(summary["loop_seconds"]) == 2
    # the model config follows the data: the tokenizer's vocab (no HF
    # tokenizer named), the corpus's answers
    data = PDP.DataPipeline(_data_config(PDP, csv, imgs)).run()
    assert train["num_answers"] == len(data.answer2id)
    stats = json.loads((out / "run_stats.json").read_text())
    assert {"data_pipeline", "model_pipeline",
            "training_pipeline"} <= set(stats["stages"])
    ev = PVP.main(base + ["--mode", "evaluate", "--resume", str(ck)])
    assert sorted(ev["metrics"]) == sorted(train["final_metrics"])
    assert all(np.isfinite(v) for v in ev["metrics"].values())
    inf = PVP.main(base + ["--mode", "inference", "--resume", str(ck)])
    results = json.loads((out / "inference_results.json").read_text())
    n_test = len(data.test_loader.dataset)
    assert inf["num_predictions"] == len(results) == n_test
    questions = [s.question for s in data.test_loader.dataset.samples]
    assert [r["question"] for r in results] == questions
    for r in results:
        assert r["answer"] in data.answer2id and 0 < r["confidence"] <= 1
        assert len(r["top_answers"]) == 5


def test_cli_default_device_is_the_card(corpus, tmp_path):
    """Without --device the pipeline asks for the card; on a host without
    one it raises, it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    csv, imgs = corpus
    yaml_path = tmp_path / "cfg.yaml"
    _write_config(yaml_path, csv, imgs, 50, 2, tmp_path / "o",
                  tmp_path / "ck")
    with pytest.raises(RuntimeError, match="CUDA"):
        PVP.main(["--config", str(yaml_path), "--mode", "train"])


def _flag_values(parser):
    """One argv per option string of ``parser`` (each alias apart), with a
    value its type and choices accept."""
    for action in parser._actions:
        for opt in action.option_strings:
            if opt in ("-h", "--help", "--config"):
                continue
            if action.nargs == 0:
                yield [opt]
            elif action.choices:
                yield [opt, list(action.choices)[-1]]
            elif action.type is int:
                yield [opt, "3"]
            elif action.type is float:
                yield [opt, "0.25"]
            else:
                yield [opt, "some-value"]


def _merged(mod, argv):
    args = mod.build_argparser().parse_args(argv)
    overrides = {k: v for k, v in vars(args).items() if k != "config"}
    return mod.merge_cli_overrides(mod.VQAPipelineConfig(), overrides)


def _comparable(cfg) -> dict:
    d = cfg.to_dict()
    # both configs carry the mesh; the port's device is its own field
    d["model"] = {k: v for k, v in d["model"].items() if k != "device"}
    return d


def test_argparser_maps_every_flag_like_jax():
    """Every flag and alias of the JAX CLI sets the same config field in
    the port; --device is the port's only addition (model.device)."""
    jp, pp = JVP.build_argparser(), PVP.build_argparser()
    jflags = {o for a in jp._actions for o in a.option_strings}
    pflags = {o for a in pp._actions for o in a.option_strings}
    assert pflags == jflags | {"--device"}
    argvs = list(_flag_values(jp))
    assert len(argvs) == len(jflags - {"-h", "--help", "--config"}) == 28
    assert _comparable(PVP.VQAPipelineConfig()) == \
        _comparable(JVP.VQAPipelineConfig())
    for argv in argvs:
        got, want = _merged(PVP, argv), _merged(JVP, argv)
        assert _comparable(got) == _comparable(want), argv
        assert _comparable(got) != _comparable(PVP.VQAPipelineConfig()), \
            argv
    assert _merged(PVP, ["--device", "cpu"]).model.device == "cpu"
    assert PVP.VQAPipelineConfig().model.device == "cuda"


def test_config_yaml_and_overrides_match_jax(tmp_path):
    """to_yaml / from_yaml round trip, and dotted overrides coerced by
    type, as the JAX package's config helpers."""
    over = {"training.optimizer.learning_rate": "0.5",
            "data.batch_size": "7", "model.model.moe.use_moe": "true",
            "training.expert_mask": [1, 0], "seed": None}
    got = PVP.merge_cli_overrides(PVP.VQAPipelineConfig(), over)
    want = JVP.merge_cli_overrides(JVP.VQAPipelineConfig(), over)
    assert _comparable(got) == _comparable(want)
    assert got.training.optimizer.learning_rate == 0.5
    assert got.training.expert_mask == (1, 0)
    path = tmp_path / "c.yaml"
    got.to_yaml(path)
    assert PVP.VQAPipelineConfig.from_yaml(path) == got
    assert _comparable(JVP.VQAPipelineConfig.from_yaml(path)) == \
        _comparable(want)
    assert PTP.TrainingPipelineConfig.from_yaml(path, "training") == \
        got.training


# -- what once named its ROADMAP item -----------------------------------------
@pytest.mark.parametrize("field", ["pretrained_visual", "pretrained_text"])
def test_model_pipeline_pretrained_towers_name_their_item(field, tmp_path,
                                                          monkeypatch):
    """Pretrained towers (once ROADMAP item 13) come from a local HF
    directory or the local HF cache only: a hub name absent from the
    cache raises ``OSError`` before any model is built, as the JAX
    pipeline's ``AutoModel.from_pretrained(..., local_files_only=True)``
    does (``tests/test_torch_hf_pipelines.py`` grafts towers saved to
    disk)."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    pipe = PMP.ModelPipeline(PMP.ModelPipelineConfig(
        device="cpu", **{field: "vinai/phobert-base"}))
    with pytest.raises(OSError, match="local Hugging Face cache"):
        pipe.run(num_answers=3)
    with pytest.raises(OSError):
        JMP.ModelPipeline(JMP.ModelPipelineConfig(
            validate_forward=False,
            **{field: "vinai/phobert-base"})).run(num_answers=3)


def test_vqa_pipeline_knowledge_names_its_item(corpus, tmp_path):
    """The CLI's options that once named their ROADMAP item (the name is
    kept from ``--use-knowledge``, then batch mixing) now run:
    ``--mix-mode both --mix-alpha 0.3`` and a freezing strategy from the
    YAML train an epoch, the frozen visual encoder unchanged and the
    summary naming them."""
    csv, imgs = corpus
    yaml_path = tmp_path / "cfg.yaml"
    cfg = _write_config(yaml_path, csv, imgs, 50, 2, tmp_path / "o",
                        tmp_path / "ck")
    cfg.replace(training=cfg.training.replace(
        strategy="freeze_visual")).to_yaml(yaml_path)
    seen = {}
    real = PTP.TrainingPipeline.run

    def run(self, model, *args):
        seen["before"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        out = real(self, model, *args)
        seen["after"] = dict(model.named_parameters())
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PTP.TrainingPipeline, "run", run)
        out = PVP.main(["--config", str(yaml_path), "--device", "cpu",
                        "--mode", "train", "--epochs", "1",
                        "--mix-mode", "both", "--mix-alpha", "0.3"])
    training = out["config"]["training"]
    assert (training["mix_mode"], training["mix_alpha"],
            training["strategy"]) == ("both", 0.3, "freeze_visual")
    assert np.isfinite(out["history"][0]["train_loss"])
    for n, p in seen["before"].items():
        same = torch.equal(seen["after"][n].detach(), p)
        assert same == n.startswith("visual_encoder"), n


# -- the smaller pieces -------------------------------------------------------
def test_model_pipeline_infers_answers_and_partial_load(tmp_path):
    """num_answers from the answer head's bias when the metadata has none;
    a checkpoint with neither raises; partial_load copies what matches by
    name and shape and reports the rest."""
    cfg = _model_config(PC, 30, 5)
    pipe = PMP.ModelPipeline(PMP.ModelPipelineConfig(model=cfg,
                                                     device="cpu"))
    src = pipe.run(num_answers=7).model
    params = {n: p.detach().clone() for n, p in src.named_parameters()}
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "a")))
    mgr.save(1, {"params": params}, metadata={"epoch": 0})
    out, _ = pipe.load_checkpoint(str(tmp_path / "a"))
    assert out.model.config.num_answers == 7
    for n, p in out.model.named_parameters():
        assert torch.equal(p, params[n]), n
    # a model of another answer count: the head's leaves are skipped
    other = pipe.run(num_answers=4).model
    _, skipped = partial_load(params, other)
    assert sorted(s.split(":")[0] for s in skipped) == [
        "answer_head.classifier.bias", "answer_head.classifier.weight"]
    assert torch.equal(other.text_encoder.token_embed.weight,
                       params["text_encoder.token_embed.weight"])
    bad = {n: p for n, p in params.items() if "classifier" not in n}
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "b")))
    mgr.save(1, {"params": bad})
    with pytest.raises(ValueError, match="num_answers"):
        pipe.load_checkpoint(str(tmp_path / "b"))


def test_result_manager_matches_jax(tmp_path):
    rows = [("câu hỏi một", "màu đỏ", 0.8, 3.5), ("hai", "phải", 0.4, 1.25),
            ("ba?", "con mèo", 0.55, 7.0)]
    meta = {"created": "fixed", "model": "tiny"}
    pm, jm = InferenceResultManager(meta), JRM(meta)
    for q, a, c, ms in rows:
        top = [{"answer": a, "confidence": c}]
        pm.add(PredictionResult(q, a, c, top, ms), split="test")
        jm.add(JResult(q, a, c, top, ms), split="test")
    assert len(pm) == len(jm) == 3
    for save in ("save_json", "save_jsonl", "save_csv"):
        p = getattr(pm, save)(tmp_path / f"p_{save}")
        j = getattr(jm, save)(tmp_path / f"j_{save}")
        assert p.read_bytes() == j.read_bytes(), save
    assert pm.summary() == jm.summary()
    assert pm.sample_dump(2) == jm.sample_dump(2)
    back = InferenceResultManager.load(tmp_path / "p_save_json")
    assert back.results == pm.results and back.metadata == meta


def test_set_seed_seeds_every_host_generator():
    from vivqa_tpu_torch.utils.seeding import set_seed
    draws = []
    for _ in range(2):
        assert set_seed(1234) == 1234
        draws.append((random.random(), float(np.random.rand()),
                      float(torch.rand(()))))
    assert draws[0] == draws[1]


def test_create_tokenizer_matches_jax():
    from vivqa_tpu.data.tokenizer import create_tokenizer as jcreate
    from vivqa_tpu_torch.data.tokenizer import create_tokenizer
    corpus = ["con mèo màu gì?", "có bao nhiêu con chó", "màu đỏ", "hai"]
    for name in (None, "no-such-local-tokenizer"):
        p, j = create_tokenizer(name, 6, corpus), jcreate(name, 6, corpus)
        assert type(p).__name__ == type(j).__name__ == "WhitespaceTokenizer"
        assert p.vocab == j.vocab
        np.testing.assert_array_equal(p.encode_batch(corpus)["input_ids"],
                                      j.encode_batch(corpus)["input_ids"])


NEW_MODULES = [
    "config/base.py", "utils/yaml_io.py", "utils/seeding.py",
    "utils/memory_guard.py", "data/synthetic.py", "data/actions.py",
    "data/augmentation.py", "data/fastloader.py", "data/dataset.py",
    "data/loader.py", "data/tokenizer.py", "data/__init__.py",
    "train/checkpoint.py", "eval/evaluator.py", "eval/result_manager.py",
    "pipelines/data_pipeline.py", "pipelines/model_pipeline.py",
    "pipelines/training_pipeline.py", "pipelines/vqa_pipeline.py",
    "pipelines/common.py", "pipelines/generative_training_pipeline.py",
    "pipelines/__init__.py", "pipelines/generative_vqa_pipeline.py",
    "pipelines/vivqa_evaluation.py", "utils/profiling.py",
    "utils/__init__.py", "bench.py", "bench_serving.py",
    "bench_convergence.py", "bench_convergence_gen.py",
    "knowledge/__init__.py", "knowledge/vietnamese.py",
    "knowledge/document_store.py", "knowledge/vector_store.py",
    "knowledge/encoders.py", "knowledge/retrievers.py", "knowledge/rag.py",
    "knowledge/provider.py", "knowledge/utils.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_imports_no_jax(module):
    """No import statement of the slice's modules, at top level or inside
    a function, names JAX, its libraries or the JAX package."""
    tree = ast.parse((REPO / "vivqa_tpu_torch" / module).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "orbax", "vivqa_tpu")]
    assert not bad, bad
