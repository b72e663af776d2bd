"""The port's generative CLI pipeline against the JAX package, on the CPU:
``GenerativeVQAPipeline`` in its four modes, ``vivqa_evaluation``, the
generative data path, the command line flag by flag, the config helpers,
the device stopwatch (``utils/profiling.py``), the fitted serving bench
and the two convergence benches, and the options that name a ROADMAP
item instead of running.

One JAX init is carried across: the JAX pipeline's own setup makes it
and saves it as an orbax checkpoint, the port's weight bridge converts
it into a port checkpoint, and each side's pipeline resumes from its
own. Both train two epochs in f32 (the tiny model of
tests/test_pipelines.py: image 16, width 32, one layer each, dropout 0),
the JAX side on a one-device mesh with the XLA attention, the port on
the CPU with the plain attention. The evaluate, inference, demo and
ViVQA runs resume from the init's checkpoints, so both decode with the
same parameters.
"""

from __future__ import annotations

import ast
import builtins
import contextlib
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_support import kept_prng_impl, shape_tree
from vivqa_tpu.data import fastloader as JF
from vivqa_tpu.metrics import (BLEUScore as JBLEU, CIDErScore as JCIDEr,
                               ExactMatchAccuracy as JEM,
                               METEORScore as JMETEOR,
                               PrecisionRecallF1 as JPRF,
                               ROUGEScore as JROUGE)
from vivqa_tpu.models import config as JC
from vivqa_tpu.parallel import MeshConfig
from vivqa_tpu.parallel import create_mesh as j_create_mesh
from vivqa_tpu.pipelines import data_pipeline as JDP
from vivqa_tpu.pipelines import generative_training_pipeline as JGT
from vivqa_tpu.pipelines import generative_vqa_pipeline as JGP
from vivqa_tpu.pipelines import vivqa_evaluation as JVE
from vivqa_tpu.train import OptimizerConfig as JOpt
from vivqa_tpu.train.checkpoint import CheckpointConfig as JCkptConfig
from vivqa_tpu.train.checkpoint import CheckpointManager as JCkpt
from vivqa_tpu_torch import bench_convergence, bench_convergence_gen
from vivqa_tpu_torch import bench_serving
from vivqa_tpu_torch.data import fastloader as PF
from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import load_flax_params
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.pipelines import data_pipeline as PDP
from vivqa_tpu_torch.pipelines import generative_training_pipeline as PGT
from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as PGP
from vivqa_tpu_torch.pipelines import vivqa_evaluation as PVE
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager)
from vivqa_tpu_torch.train.optimizers import OptimizerConfig as POpt
from vivqa_tpu_torch.train.state import generative_loss_fn
from vivqa_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, S, BATCH, EPOCHS, LR = 40, 16, 8, 2, 1e-2
# f32 on both sides: the losses of two epochs agree to 1e-4 relative
# (JAX rounds its embedding gradient to bf16, which AdamW's normalised
# update nearly cancels); the decoded strings, and so every metric, agree
# exactly; beam scores to 1e-4
LOSS_RTOL = SCORE_TOL = 1e-4
# history values that are not functions of the decoded strings
NOT_STRINGS = ("train_loss", "perplexity", "tokens_per_sec")
VIVQA_SAMPLES = 13          # a partial last batch of 5 at batch 8


def _model_config(mod):
    return mod.GenerativeVQAConfig(
        visual=mod.VisualEncoderConfig(image_size=S, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype="float32"),
        text=mod.TextEncoderConfig(vocab_size=512, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dropout=0.0, dtype="float32"),
        fusion_dim=32, fusion_layers=1, fusion_heads=2, decoder_layers=1,
        decoder_heads=2, decoder_dim=32, decoder_ff_dim=64, dropout=0.0,
        dtype="float32")


def _data_config(mod, csv, imgs):
    return mod.DataPipelineConfig(
        csv_path=csv, image_dir=imgs, image_size=S, max_question_length=8,
        max_answer_length=6, batch_size=BATCH, augmentation_strength="light",
        generative=True)


def _training_config(mod, opt, directory):
    return mod.GenerativeTrainingConfig(
        num_epochs=EPOCHS, optimizer=opt(learning_rate=LR),
        checkpoint_dir=str(directory), early_stopping_patience=10,
        log_every=1)


def _jax_config(csv, imgs, tmp, **kw):
    return JGP.GenerativeVQAPipelineConfig(
        data=_data_config(JDP, csv, imgs), model=_model_config(JC),
        training=_training_config(JGT, JOpt, tmp / "ck_jax"),
        mesh=MeshConfig(model_axis=1), output_dir=str(tmp / "out_jax"),
        **kw)


def _port_config(csv, imgs, tmp, **kw):
    return PGP.GenerativeVQAPipelineConfig(
        data=_data_config(PDP, csv, imgs), model=_model_config(PC),
        training=_training_config(PGT, POpt, tmp / "ck_port"),
        device="cpu", output_dir=str(tmp / "out_port"), **kw)


def _decoding(cfg, strategy):
    return cfg.replace(training=cfg.training.replace(
        decode_strategy=strategy, num_beams=4))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    csv, imgs = generate_synthetic_vivqa(d, n=N, image_size=S,
                                         learnable=True, seq_answers=True)
    return str(csv), str(imgs)


@contextlib.contextmanager
def _one_device():
    """The JAX pipeline on a one-device mesh, as its own tests run it,
    with the PRNG implementation that its ``set_seed`` switches restored
    after it."""
    with pytest.MonkeyPatch.context() as mp, kept_prng_impl():
        mp.setattr(JGP, "create_mesh", lambda c: j_create_mesh(
            c, devices=jax.devices("cpu")[:1]))
        yield


def _jax_run(cfg):
    with _one_device():
        return JGP.GenerativeVQAPipeline(cfg).run()


def _demo(run, cfg, answers):
    """``run(cfg)`` in demo mode with ``input`` answering from
    ``answers``; the printed lines."""
    feed = iter(answers)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(builtins, "input", lambda prompt="": next(feed))
        run(cfg.replace(mode="demo"))
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both pipelines: train two epochs from one init, then evaluate
    (greedy, beam-4), inference, demo and the ViVQA evaluation from that
    init's checkpoints."""
    csv, imgs = corpus
    tmp = tmp_path_factory.mktemp("gen_cli")
    jcfg, pcfg = _jax_config(csv, imgs, tmp), _port_config(csv, imgs, tmp)

    # the JAX pipeline's init, saved for both sides' resume
    with _one_device():
        _, jm, params, _ = JGP.GenerativeVQAPipeline(jcfg)._setup()
    params = jax.device_get(params)
    meta = {"epoch": -1, "config": jm.config.to_dict()}
    mgr = JCkpt(JCkptConfig(directory=str(tmp / "init_jax")))
    mgr.save(0, {"params": params}, metadata=meta)
    mgr.close()
    init = load_flax_params(GenerativeVQAModel(
        PC.GenerativeVQAConfig.from_dict(meta["config"])), params)
    CheckpointManager(CheckpointConfig(directory=str(tmp / "init_port"))
                      ).save(0, {"params": dict(init.named_parameters())},
                             metadata=meta)

    out = {"jcfg": jcfg, "pcfg": pcfg, "tmp": tmp}
    out["jax_train"] = _jax_run(jcfg.replace(resume=str(tmp / "init_jax")))
    out["port_train"] = PGP.GenerativeVQAPipeline(
        pcfg.replace(resume=str(tmp / "init_port"))).run()
    jmgr = JCkpt(JCkptConfig(directory=str(tmp / "ck_jax"),
                             best_metric="bleu"))
    out["jax_steps"], out["jax_best"] = jmgr.all_steps(), jmgr.best_step()
    jmgr.close()
    pmgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp / "ck_port"), best_metric="bleu"))
    out["port_steps"], out["port_best"] = pmgr.all_steps(), pmgr.best_step()

    # the decoding modes resume from the init on both sides: a model of
    # two epochs answers with EOS alone, the init with a string of
    # tokens, which holds each decode step to the JAX package's
    jres = jcfg.replace(resume=str(tmp / "init_jax"))
    pres = pcfg.replace(resume=str(tmp / "init_port"))
    for strategy in ("greedy", "beam"):
        out[f"jax_{strategy}"] = _jax_run(
            _decoding(jres, strategy).replace(mode="evaluate"))
        out[f"port_{strategy}"] = PGP.GenerativeVQAPipeline(
            _decoding(pres, strategy).replace(mode="evaluate")).run()
    out["jax_inference"] = _jax_run(jres.replace(mode="inference"))
    out["port_inference"] = PGP.GenerativeVQAPipeline(
        pres.replace(mode="inference")).run()

    images = sorted(Path(imgs).iterdir())
    answers = [str(images[0]), "có bao nhiêu con mèo", str(images[7]),
               "màu gì", "quit"]
    out["jax_demo"] = _demo(_jax_run, jres, answers)
    out["port_demo"] = _demo(
        lambda c: PGP.GenerativeVQAPipeline(c).run(), pres, answers)

    def vivqa(mod, ckpt, name, **kw):
        return mod.VivqaEvaluationPipeline(mod.VivqaEvaluationConfig(
            checkpoint_dir=str(ckpt), csv_path=csv, image_dir=imgs,
            image_size=S, batch_size=BATCH, max_question_length=8,
            max_answer_length=6, output_dir=str(tmp / name),
            max_samples=VIVQA_SAMPLES, **kw)).evaluate()
    out["jax_vivqa"] = vivqa(JVE, tmp / "init_jax", "vivqa_jax")
    out["port_vivqa"] = vivqa(PVE, tmp / "init_port", "vivqa_port",
                              device="cpu")
    return out


# -- train, evaluate, inference, demo, ViVQA ----------------------------------
def test_train_two_epochs_matches_jax(runs):
    """Each epoch's train loss within 1e-4 relative, every metric of the
    decoded strings equal, the same checkpoints and best step."""
    jh, ph = runs["jax_train"]["history"], runs["port_train"]["history"]
    assert len(jh) == len(ph) == EPOCHS
    for j, p in zip(jh, ph):
        assert sorted(p) == sorted(j)
        for k in ("train_loss", "perplexity"):
            np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        for k, v in j.items():
            if k not in NOT_STRINGS:
                assert p[k] == v, (k, p[k], v)
        assert p["tokens_per_sec"] > 0
    assert runs["port_train"]["best_metric"] == \
        runs["jax_train"]["best_metric"]
    assert runs["port_steps"] == runs["jax_steps"]
    assert runs["port_best"] == runs["jax_best"]
    # the run learned something to decode
    assert jh[-1]["train_loss"] < jh[0]["train_loss"]


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_evaluate_from_checkpoint_matches_jax(runs, strategy):
    got = runs[f"port_{strategy}"]
    want = runs[f"jax_{strategy}"]
    assert got["metrics"] == want["metrics"]
    assert all(np.isfinite(v) for v in got["metrics"].values())
    summary = json.loads((Path(runs["pcfg"].output_dir)
                          / "pipeline_summary.json").read_text())
    assert summary["wall_seconds"] > 0


def test_inference_matches_jax(runs):
    got = json.loads(Path(runs["port_inference"]["results_path"])
                     .read_text())
    want = json.loads(Path(runs["jax_inference"]["results_path"])
                      .read_text())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["generated_answer", "question",
                                          "references", "score"]
        assert (g["question"], g["generated_answer"], g["references"]) == \
            (w["question"], w["generated_answer"], w["references"])
        assert g["score"] == pytest.approx(w["score"], rel=SCORE_TOL,
                                           abs=SCORE_TOL)
    assert any(g["generated_answer"] for g in got)


def test_demo_answers_match_jax(runs):
    """The REPL's answers to the same two questions and images: the same
    strings, the scores (printed to 2 places) equal."""
    got, want = ([line for line in runs[k] if line.startswith("answer: ")]
                 for k in ("port_demo", "jax_demo"))
    assert len(got) == 2 and got == want
    assert any(line != "answer:  (score" for line in got)


def _metrics_of(predictions) -> dict:
    """The nine metrics of a predictions file, by the JAX package's
    metric classes."""
    preds = [p["prediction"] for p in predictions]
    refs = [p["references"] for p in predictions]
    ms = {name: cls() for name, cls in (
        ("bleu", JBLEU), ("meteor", JMETEOR), ("rouge", JROUGE),
        ("cider", JCIDEr), ("em", JEM), ("prf", JPRF))}
    for m in ms.values():
        m.update(preds, refs)
    prf, rouge = ms["prf"].compute(), ms["rouge"].compute()
    return {"exact_match": ms["em"].compute().value,
            "precision": prf.metadata["precision"],
            "recall": prf.metadata["recall"], "f1": prf.value,
            "bleu": ms["bleu"].compute().value,
            "meteor": ms["meteor"].compute().value,
            "rouge_l": rouge.value, "rouge1": rouge.metadata["rouge1"],
            "cider": ms["cider"].compute().value}


def test_vivqa_evaluation_matches_jax(runs):
    """The port's ViVQA evaluation from the port checkpoint against the
    JAX package's from its orbax one, same parameters: the same
    predictions for the samples read, and the nine metrics of those
    predictions. The JAX package also scores and writes the padding rows
    of the last batch (13 samples read, 16 predictions); the port scores
    and writes each sample once (ROADMAP.md Queue C)."""
    tmp = runs["tmp"]
    got = json.loads((tmp / "vivqa_port" / "predictions.json").read_text())
    want = json.loads((tmp / "vivqa_jax" / "predictions.json").read_text())
    assert runs["port_vivqa"]["num_samples"] == VIVQA_SAMPLES
    assert len(got) == VIVQA_SAMPLES
    assert len(want) == -(-VIVQA_SAMPLES // BATCH) * BATCH
    assert got == want[:VIVQA_SAMPLES]
    metrics = runs["port_vivqa"]["metrics"]
    assert metrics == _metrics_of(want[:VIVQA_SAMPLES])
    assert json.loads((tmp / "vivqa_port" / "metrics.json").read_text()) \
        == metrics
    assert len(metrics) == 9 and all(np.isfinite(v)
                                     for v in metrics.values())


def test_resume_copies_into_the_models_parameters(runs):
    """After resume the model holds the checkpoint's values in its own
    parameters (on the device it was built on)."""
    ckpt = str(runs["tmp"] / "ck_port")
    _, model = PGP.GenerativeVQAPipeline(runs["pcfg"].replace(
        resume=ckpt))._setup()
    saved, _ = CheckpointManager(CheckpointConfig(
        directory=ckpt)).restore_best()
    for n, p in model.named_parameters():
        assert p.device.type == "cpu" and torch.equal(
            p.detach(), saved["params"][n]), n


# -- the generative data path --------------------------------------------------
def test_generative_data_pipeline_batches_match_jax(corpus, monkeypatch):
    """DataPipeline(generative=True): train (two shuffled, augmented
    epochs), val and test batches equal the JAX pipeline's on the PIL
    path, pixels bit for bit, every target array and text."""
    csv, imgs = corpus
    monkeypatch.setattr(PF, "get_fastloader", lambda: None)
    monkeypatch.setattr(JF, "get_fastloader", lambda: None)

    def batches(mod):
        cfg = _data_config(mod, csv, imgs).replace(
            augmentation_strength="medium")
        out = mod.DataPipeline(cfg).run()
        return out, [b for _ in range(2) for b in out.train_loader] + \
            list(out.val_loader) + list(out.test_loader)
    pout, pb = batches(PDP)
    jout, jb = batches(JDP)
    assert pout.tokenizer.vocab == jout.tokenizer.vocab
    assert len(pb) == len(jb) == 2 * (N * 8 // 10 // BATCH) + 2
    for p, j in zip(pb, jb):
        assert sorted(p) == sorted(j)
        for k, v in j.items():
            if isinstance(v, np.ndarray):
                assert p[k].dtype == v.dtype, k
                np.testing.assert_array_equal(p[k], v, err_msg=k)
            else:
                assert p[k] == v, k
    assert [b["_num_valid"] for b in pb[-2:]] == [4, 4]


# -- the command line and the config ------------------------------------------
def _flag_values(parser):
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
    overrides = {k: v for k, v in vars(args).items()
                 if k != "config" and not k.startswith("_")}
    cfg = mod.merge_cli_overrides(mod.GenerativeVQAPipelineConfig(),
                                  overrides)
    return mod._apply_flag_aliases(cfg, args)


def _comparable(cfg) -> dict:
    # both configs carry the mesh; the port's device is its own field
    return {k: v for k, v in cfg.to_dict().items() if k != "device"}


def test_argparser_maps_every_flag_like_jax():
    """Every flag and alias of the JAX CLI, with the alias fan-outs
    (--hidden-size, --num-attention-heads, --freeze-*), sets the same
    config fields in the port; --device is the port's only addition, and
    the compatibility no-ops (--use-amp, --num-workers) change nothing."""
    jp, pp = JGP.build_argparser(), PGP.build_argparser()
    jflags = {o for a in jp._actions for o in a.option_strings}
    pflags = {o for a in pp._actions for o in a.option_strings}
    assert pflags == jflags | {"--device"}
    argvs = list(_flag_values(jp))
    assert len(argvs) == len(jflags - {"-h", "--help", "--config"}) == 56
    default = _comparable(PGP.GenerativeVQAPipelineConfig())
    assert default == _comparable(JGP.GenerativeVQAPipelineConfig())
    no_ops = {"--use-amp", "--num-workers", "--disable-resource-management"}
    for argv in argvs:
        got, want = _merged(PGP, argv), _merged(JGP, argv)
        assert _comparable(got) == _comparable(want), argv
        assert (_comparable(got) == default) == (argv[0] in no_ops), argv
    with pytest.raises(SystemExit):
        _merged(PGP, ["--freeze-visual", "--freeze-text"])
    assert _merged(PGP, ["--device", "cpu"]).device == "cpu"
    assert PGP.GenerativeVQAPipelineConfig().device == "cuda"


def test_config_yaml_and_overrides_match_jax(tmp_path):
    over = {"training.optimizer.learning_rate": "0.5",
            "data.batch_size": "7", "model.moe.use_moe": "true",
            "training.expert_mask": [1, 0], "seed": None,
            "model.visual.num_layers": "3"}
    got = PGP.merge_cli_overrides(PGP.GenerativeVQAPipelineConfig(), over)
    want = JGP.merge_cli_overrides(JGP.GenerativeVQAPipelineConfig(), over)
    assert _comparable(got) == _comparable(want)
    assert got.training.expert_mask == (1, 0)
    assert got.model.visual.num_layers == 3 and got.data.generative
    path = tmp_path / "c.yaml"
    got.to_yaml(path)
    assert PGP.GenerativeVQAPipelineConfig.from_yaml(path) == got
    assert _comparable(JGP.GenerativeVQAPipelineConfig.from_yaml(path)) == \
        _comparable(want)


def test_model_config_metadata_round_trip():
    """GenerativeVQAConfig from the JSON metadata a checkpoint holds
    rebuilds every nested sub-config (visual, text, moe, knowledge), in
    the port and in the JAX package alike."""
    cfg = _model_config(PC).replace(
        moe=PC.MoEModelConfig(use_moe=True, num_experts=3, top_k=1,
                              moe_position="decoder"),
        knowledge=PC.KnowledgeModelConfig(num_retrieved=7,
                                          fusion_strategy="gated"),
        vocab_size=77, max_answer_length=9, bos_token_id=5)
    meta = json.loads(json.dumps({"config": cfg.to_dict()}))
    back = PC.GenerativeVQAConfig.from_dict(meta["config"])
    assert back == cfg
    assert isinstance(back.moe, PC.MoEModelConfig)
    assert isinstance(back.knowledge, PC.KnowledgeModelConfig)
    assert back.visual.dtype == "float32" and back.text.max_length == 8
    assert JC.GenerativeVQAConfig.from_dict(meta["config"]).to_dict() == \
        cfg.to_dict()


def test_cli_default_device_is_the_card(corpus, tmp_path):
    """Without --device the CLIs ask for the card; on a host without one
    they raise, they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    csv, imgs = corpus
    with pytest.raises(RuntimeError, match="CUDA"):
        PGP.main(["--mode", "train", "--csv-path", csv, "--image-dir", imgs,
                  "--output-dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        PVE.main(["--checkpoint-dir", str(tmp_path / "none"), "--csv-path",
                  csv, "--output-dir", str(tmp_path / "v")])


def test_cli_trains_on_the_cpu_from_yaml(corpus, tmp_path):
    """``main`` with a YAML config and flags: one epoch on the CPU, the
    checkpoint, then inference from it."""
    csv, imgs = corpus
    cfg = _port_config(csv, imgs, tmp_path)
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(path)
    base = ["--config", str(path), "--device", "cpu", "--epochs", "1",
            "--checkpoint-dir", str(tmp_path / "ck"), "--output-dir",
            str(tmp_path / "out")]
    train = PGP.main(base + ["--mode", "train"])
    assert len(train["history"]) == 1 and train["config"]["device"] == "cpu"
    assert CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "ck"))).all_steps() == [N * 8 // 10 // BATCH]
    inf = PGP.main(base + ["--mode", "inference", "--resume",
                           str(tmp_path / "ck")])
    results = json.loads(Path(inf["results_path"]).read_text())
    assert len(results) == N // 10


@pytest.mark.parametrize("flag,frozen", [
    ("--freeze-visual", ("visual_encoder",)),
    ("--freeze-text", ("question_encoder", "text_encoder"))], ids=str)
def test_cli_freezes_and_runs_the_resource_manager(corpus, tmp_path,
                                                   monkeypatch, flag,
                                                   frozen):
    """``--freeze-visual`` / ``--freeze-text`` (the strategies, ported)
    leave their tower bit-equal through an epoch while the rest trains;
    ``--enable-resource-management`` starts the manager before the mode
    and stops it after."""
    from vivqa_tpu_torch import resources
    csv, imgs = corpus
    cfg = _port_config(csv, imgs, tmp_path)
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(path)
    monkeypatch.setattr(resources.manager, "_SINGLETON", None)
    rm = resources.get_resource_manager(resources.ResourceConfig(
        backup=resources.BackupConfig(emergency_dir=str(tmp_path / "em")),
        report=resources.ReportIntervalConfig(
            report_dir=str(tmp_path / "rep")),
        enable_signal_handlers=False))
    seen = {}
    real = PGT.GenerativeTrainingPipeline.run

    def run(self, model, *args):
        seen["strategy"] = self.config.strategy
        seen["running"] = rm._running
        seen["before"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        out = real(self, model, *args)
        seen["after"] = dict(model.named_parameters())
        return out
    monkeypatch.setattr(PGT.GenerativeTrainingPipeline, "run", run)
    PGP.main(["--config", str(path), "--device", "cpu", "--epochs", "1",
              "--mode", "train", flag, "--enable-resource-management",
              "--checkpoint-dir", str(tmp_path / "ck"),
              "--output-dir", str(tmp_path / "out")])
    assert seen["strategy"] == flag[2:].replace("-", "_")
    assert seen["running"] and not rm._running
    for n, p in seen["before"].items():
        same = torch.equal(seen["after"][n].detach(), p)
        assert same == n.startswith(frozen), n


@pytest.mark.parametrize("argv,item", [
    (["--use-moe", "--moe-type", "sparse"], "item 13"),
    (["--pretrained-visual", "openai/clip-vit-base-patch32"], "item 13"),
    (["--pretrained-text", "vinai/phobert-base"], "item 13")], ids=str)
def test_unported_options_name_their_item(corpus, tmp_path, monkeypatch,
                                          argv, item):
    """The options that once named ROADMAP item 13 (the ids keep it) now
    run. The pretrained towers read a local HF directory or the local HF
    cache only: a hub name absent from the cache raises ``OSError``, as
    the JAX pipeline's ``AutoModel.from_pretrained(...,
    local_files_only=True)`` does (``tests/test_torch_hf_pipelines.py``
    runs the CLI with towers saved to disk). ``--use-moe --moe-type
    sparse`` trains an epoch on the CPU: the fusion's MoE is the
    capacity-dispatch layer with the leaves of the JAX package's layer
    for the same config, and the loss is finite."""
    csv, imgs = corpus
    if "sparse" not in argv:
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
        with pytest.raises(OSError, match="local Hugging Face cache"):
            PGP.main(argv + ["--mode", "train", "--device", "cpu",
                             "--csv-path", csv, "--image-dir", imgs,
                             "--batch-size", "8",
                             "--max-question-length", "8",
                             "--max-answer-length", "6",
                             "--output-dir", str(tmp_path)])
        return
    from vivqa_tpu.models.moe.layer import create_moe_layer as j_moe
    from vivqa_tpu.models.vqa_model import moe_config_from_model as j_cfg
    from vivqa_tpu_torch.models.from_jax import check_one_to_one
    from vivqa_tpu_torch.models.moe.layer import SparseMOELayer
    path = tmp_path / "cfg.yaml"
    _port_config(csv, imgs, tmp_path).to_yaml(path)
    seen = {}
    real = PGT.GenerativeTrainingPipeline.run

    def run(self, model, *args):
        seen["model"] = model
        return real(self, model, *args)
    monkeypatch.setattr(PGT.GenerativeTrainingPipeline, "run", run)
    out = PGP.main(argv + ["--config", str(path), "--device", "cpu",
                           "--epochs", "1", "--mode", "train",
                           "--checkpoint-dir", str(tmp_path / "ck"),
                           "--output-dir", str(tmp_path / "out")])
    model = seen["model"]
    assert model.config.moe.moe_type == "sparse"
    assert isinstance(model.fusion.moe, SparseMOELayer)
    jcfg = JC.GenerativeVQAConfig.from_dict(model.config.to_dict())
    D = jcfg.fusion_dim
    shapes = jax.eval_shape(lambda x: j_moe(j_cfg(jcfg, D)).init(
        jax.random.PRNGKey(0), x), np.zeros((1, 4, D), np.float32))
    check_one_to_one(model.fusion.moe, shape_tree(shapes["params"]))
    assert np.isfinite(out["history"][0]["train_loss"])


# -- the stopwatch ---------------------------------------------------------------
def test_peak_tflops_by_card_name():
    assert profiling.peak_tflops(name="NVIDIA H100 80GB HBM3") == 989.0
    assert profiling.peak_tflops(name="NVIDIA H100 SXM5 80GB") == 989.0
    assert profiling.peak_tflops(name="NVIDIA H100 PCIe") == 756.0
    assert profiling.peak_tflops(name="NVIDIA H100 NVL") == 835.0
    assert profiling.peak_tflops(name="NVIDIA H100") is None
    assert profiling.peak_tflops(name="Tesla T4") is None
    assert profiling.peak_tflops("cpu") is None


def test_time_chained_and_time_train_steps_on_cpu():
    calls = []

    def fn(x, w):
        calls.append(x.clone())
        return {"y": x @ w, "z": (x.sum(),)}
    x, w = torch.ones(4, 4), torch.eye(4)
    per = profiling.time_chained(fn, (x, w), steps=5)
    assert np.isfinite(per) and per > 0 and len(calls) == 6

    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    class State:
        step = 0

    def train_step(state, batch):
        opt.zero_grad()
        loss = model(batch["x"]).pow(2).sum()
        loss.backward()
        opt.step()
        state.step += 1
        return state, {"loss": loss.detach()}
    state = State()
    times = profiling.time_train_steps(train_step, state,
                                       {"x": torch.ones(3, 4)}, steps=3)
    assert state.step == 3 and times.event_ms == []
    assert len(times.host_ms) == 3 and all(t > 0 for t in times.host_ms)
    assert all(torch.isfinite(m["loss"]) for m in times.metrics)
    assert times.median_ms == sorted(times.host_ms)[1]


def _products(model, batch) -> dict:
    """The multiply-adds of one forward of the tiny generative model,
    from its modules' shapes, by kind: each Dense on its input, the
    patch convolution, the tied logits, and the attention's two batched
    products (scores and values) per call."""
    from vivqa_tpu_torch.ops import embedding, flash_attention as fa
    vis = model.config.visual
    patches = batch["pixel_values"].shape[0] * (
        vis.image_size // vis.patch_size) ** 2
    macs = {"dense": 0, "logits": 0, "attention": 0,
            "conv": patches * 3 * vis.patch_size ** 2 * vis.hidden_dim}

    def dense(mod, inp, out):
        macs["dense"] += (inp[0].numel() // mod.in_features
                          * mod.in_features * mod.out_features)
    handles = [m.register_forward_hook(dense) for m in model.modules()
               if isinstance(m, torch.nn.Linear)]
    real_attention, real_attend = fa.attention_reference, \
        embedding.Embed.attend

    def attention(q, k, v, *a, **kw):
        macs["attention"] += 2 * q.shape[:3].numel() * k.shape[2] \
            * q.shape[3]
        return real_attention(q, k, v, *a, **kw)

    def attend(self, query):
        macs["logits"] += query.numel() * self.weight.shape[0]
        return real_attend(self, query)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "attention_reference", attention)
        mp.setattr(embedding.Embed, "attend", attend)
        model.train()
        with torch.no_grad():
            generative_loss_fn()(model, batch, torch.Generator())
    for h in handles:
        h.remove()
    return macs


def test_train_step_flops_counts_the_products(runs):
    """One step's forward and backward of the tiny model by
    FlopCounterMode against the products counted here from the shapes:
    each product of the forward once, and in the backward two for each
    Dense and the tied logits (the input's and the weight's gradient),
    one for the patch convolution (the pixels take no gradient), and
    seven for each attention call's two (the plain backward's dQ and
    dK/dV passes each recompute the scores and dP, as the kernels do,
    then take dQ, and dK and dV). The caller's model keeps no
    gradient."""
    data, model = PGP.GenerativeVQAPipeline(runs["pcfg"])._setup()
    batch = PGT.batch_to_device(next(iter(data.train_loader)),
                                torch.device("cpu"))
    macs = _products(model, batch)
    assert all(macs.values()), macs
    want = 2 * (3 * (macs["dense"] + macs["logits"]) + 2 * macs["conv"]
                + 4.5 * macs["attention"])
    assert profiling.train_step_flops(generative_loss_fn(), model,
                                      batch) == want
    assert all(p.grad is None for p in model.parameters())


# -- the fitted serving bench ------------------------------------------------
def test_same_up_to_eos():
    eos = 2
    a = torch.tensor([[5, 2, 1, 1], [5, 6, 7, 8]])
    assert bench_serving.answer_lengths(a, eos) == [1, 4]
    assert bench_serving.same_up_to_eos(a, torch.tensor(
        [[5, 2, 9, 9], [5, 6, 7, 8]]), eos)
    assert not bench_serving.same_up_to_eos(a, torch.tensor(
        [[5, 3, 1, 1], [5, 6, 7, 8]]), eos)
    assert not bench_serving.same_up_to_eos(a, a[:, :3], eos)


def test_fitted_bench_on_a_trained_checkpoint_on_cpu(runs, corpus):
    """The fitted mode's function on the port run's checkpoint, read
    through the port's checkpoint reader on the CPU: early exit and the
    fixed loop decode the same tokens up to each row's EOS, each result
    has its answer length, the early one its speedup."""
    model, meta = PVE.load_model_from_checkpoint(
        str(runs["tmp"] / "ck_port"), device="cpu")
    assert meta["epoch"] in (0, 1)
    host = bench_serving.fitted_batch(model.config, BATCH, N,
                                      str(Path(corpus[0]).parent))
    res = bench_serving.bench_fitted(
        model, host, [4], ["greedy", "beam"], windows=3, iters=1,
        lat_calls=1)
    assert sorted(res) == ["beam_b4_early", "beam_b4_fixed32",
                           "greedy_b4_early", "greedy_b4_fixed32"]
    for key, r in res.items():
        assert 0 <= r["mean_answer_tokens"] <= model.config.max_answer_length
        if key.endswith("early"):
            assert r["tokens_equal_to_fixed"] and r["speedup_vs_fixed"] > 0


# -- the convergence benches --------------------------------------------------
def _json_keys(script: str) -> set:
    """The keys of the dict a root script prints (``out = {...}`` and
    ``out[...] = ...`` in its main)."""
    tree = ast.parse((REPO / script).read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "out" and \
                    isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            elif isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and t.value.id == "out":
                keys.add(t.slice.value if isinstance(t.slice, ast.Constant)
                         else ast.unparse(t.slice))
    return keys


def test_convergence_bench_prints_the_root_scripts_keys(monkeypatch,
                                                        capsys):
    monkeypatch.setenv("CONV_SAMPLES", "40")
    monkeypatch.setenv("CONV_EPOCHS", "1")
    out = bench_convergence.main("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    want = _json_keys("bench_convergence.py") - {"augmentation"}
    assert set(out) == want | {"device", "card"}
    assert out["device"] == "cpu" and len(out["val_em_curve"]) == 1


def test_convergence_bench_seed_dtype_and_dropout_knobs(monkeypatch):
    """CONV_SEED, CONV_DTYPE and CONV_DROPOUT reach the pipeline's model
    and training and are named in the line; the held-out split stays the
    same."""
    from vivqa_tpu_torch.pipelines import vqa_pipeline
    seen = []
    real = vqa_pipeline.VQAPipeline.run

    def run(self):
        seen.append(self.config)
        return real(self)
    monkeypatch.setattr(vqa_pipeline.VQAPipeline, "run", run)
    monkeypatch.setenv("CONV_SAMPLES", "40")
    monkeypatch.setenv("CONV_EPOCHS", "1")
    default = bench_convergence.main("cpu")
    monkeypatch.setenv("CONV_SEED", "7")
    monkeypatch.setenv("CONV_DTYPE", "float32")
    monkeypatch.setenv("CONV_DROPOUT", "0")
    variant = bench_convergence.main("cpu")
    assert "variant" not in default
    assert variant["variant"] == {"seed": 7, "dtype": "float32",
                                  "dropout": 0.0}
    base, other = seen
    assert (other.seed, other.model.seed, other.training.seed) == (7, 7, 7)
    assert base.data.seed == other.data.seed == 42
    model = other.model.model
    assert model.dtype == model.visual.dtype == model.text.dtype \
        == "float32"
    assert model.text.dropout == model.fusion.dropout \
        == model.head.dropout == 0.0
    assert base.model.model.dtype == "bfloat16"
    assert base.model.model.text.dropout == base.model.model.head.dropout \
        == 0.1


def test_convergence_bench_mix_mode_names_its_item(monkeypatch):
    """CONV_MIX_MODE reaches the training pipeline (batch mixing is
    ported; the name is kept from when it raised) and the line names it
    under ``augmentation``, as the root script's does."""
    monkeypatch.setenv("CONV_SAMPLES", "40")
    monkeypatch.setenv("CONV_EPOCHS", "1")
    monkeypatch.setenv("CONV_MIX_MODE", "both")
    out = bench_convergence.main("cpu")
    assert out["augmentation"]["mix_mode"] == "both"
    assert len(out["val_em_curve"]) == 1


def test_generative_convergence_bench_prints_the_root_scripts_keys(
        monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("GEN_SAMPLES", "40")
    monkeypatch.setenv("GEN_EPOCHS", "1")
    monkeypatch.setenv("GEN_BEAMS", "2")
    monkeypatch.setenv("GEN_CKPT", str(tmp_path / "ck"))
    out = bench_convergence_gen.main("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    want = _json_keys("bench_convergence_gen.py") - {
        "f'beam{beams}_exact_match'"}
    assert set(out) == want | {"beam2_exact_match", "device", "card"}
    assert len(out["val_em_curve"]) == 1
    # the BLEU-best checkpoint the beam evaluation resumed from
    assert CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "ck"))).all_steps()
