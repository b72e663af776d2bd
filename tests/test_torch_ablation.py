"""The port's ablation study against the JAX package's, and gradient
accumulation against ``optax.MultiSteps``.

The host-side modules (matrix, masks, evaluator, analyzer, reporter) are
copies: the JAX tests' inputs (tests/test_ablation.py) go through both
packages, and the matrices, masks, statistics and report files must be
equal, the files byte for byte. The trainer, runner and CLI run the
port's models on the CPU at a tiny size: a study of full, dense,
single-expert and post-hoc rows with resume, one generative experiment,
and the CLI's train, resume, ``--report-only`` and ``--dry-run``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import vivqa_tpu.ablation as JA
import vivqa_tpu_torch.ablation as PA
from test_ablation import _fake_results
from test_torch_support import assert_close
from vivqa_tpu.ablation import evaluator as JEV
from vivqa_tpu.ablation import run_ablation as JRUN
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu_torch.ablation import evaluator as PEV
from vivqa_tpu_torch.ablation import run_ablation as PRUN
from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.layers import Dense
from vivqa_tpu_torch.pipelines import training_pipeline as PTP
from vivqa_tpu_torch.pipelines.data_pipeline import (DataPipeline,
                                                     DataPipelineConfig)
from vivqa_tpu_torch.train import optimizers as PO

torch.set_num_threads(1)


# -- the host-side modules ---------------------------------------------------
SEARCHES = [
    dict(num_experts=4, subset_sizes=(2,), max_subsets_per_size=3,
         router_types=("noisy_topk", "soft", "topk"), top_k_values=(1, 2),
         load_balance_weights=(0.01,)),
    dict(num_experts=3, include_single_expert=True,
         include_leave_one_out=True, post_hoc_masks=True),
    dict(num_experts=6, include_single_expert=False,
         router_types=("noisy_topk", "soft"), cross_expert_router=True),
]


@pytest.mark.parametrize("search", SEARCHES, ids=str)
def test_experiment_matrix_and_yaml_match_jax(search, tmp_path):
    want = JA.AblationConfig(search=JA.AblationSearchSpace(**search))
    got = PA.AblationConfig(search=PA.AblationSearchSpace(**search))
    assert [(e.experiment_id, e.priority, e.to_dict()) for e in
            got.generate_experiment_matrix()] == \
        [(e.experiment_id, e.priority, e.to_dict()) for e in
         want.generate_experiment_matrix()]
    want.to_yaml(tmp_path / "j.yaml")
    got.to_yaml(tmp_path / "p.yaml")
    assert (tmp_path / "j.yaml").read_bytes() == \
        (tmp_path / "p.yaml").read_bytes()
    assert PA.AblationConfig.from_yaml(tmp_path / "j.yaml") == got


MASK_CASES = [("full", ()), ("no_moe", ()), ("single_expert", (2,)),
              ("leave_one_out", (1,)), ("subset", (0, 3)), ("subset", ())]


@pytest.mark.parametrize("mode,idx", MASK_CASES, ids=str)
def test_expert_masks_match_jax(mode, idx):
    outs = []
    for mod in (JA, PA):
        try:
            outs.append(mod.build_expert_mask(
                mod.ExpertAblationConfig(mode, idx), 4))
        except ValueError as e:
            outs.append(("raises", str(e)))
    assert outs[0] == outs[1]
    assert PA.compute_expert_index_ranges(2, 2, 1, 3) == \
        JA.compute_expert_index_ranges(2, 2, 1, 3)
    assert PRUN.parse_experiment_ranges("1,3,5-7,2-2") == \
        JRUN.parse_experiment_ranges("1,3,5-7,2-2")


def test_config_modifiers_and_telemetry_match_jax():
    from vivqa_tpu.models import config as JC
    out = []
    for mod, cfgmod in ((JA, JC), (PA, PC)):
        base = cfgmod.VQAModelConfig(moe=cfgmod.MoEModelConfig(
            use_moe=True, moe_type="vqa", top_k=2))
        swapped = mod.apply_router_ablation(
            base, mod.RouterAblationConfig("soft", 0, 0.05))
        dense = mod.apply_expert_ablation(
            base, mod.ExpertAblationConfig("no_moe"))
        out.append((swapped.to_dict(), dense.to_dict()))
    assert out[0] == out[1]
    metrics = {"expert_usage": np.array([0.5, 0.0, 0.25], np.float32),
               "routing_entropy": np.float32(0.7),
               "load_imbalance": np.float32(0.3)}
    assert PA.collect_moe_metrics(metrics) == JA.collect_moe_metrics(metrics)
    assert PA.collect_moe_metrics({}) == JA.collect_moe_metrics({}) == {}


def _both_results(masks: bool):
    """tests/test_ablation.py's fake results in each package's
    ExperimentResult, with that file's correct masks when ``masks``."""
    jres = _fake_results()
    if masks:
        jres[0].correct_mask = [1] * 60 + [0] * 40
        jres[2].correct_mask = [1] * 48 + [0] * 12 + [0] * 40
        jres[3].correct_mask = ([1] * 58 + [0] * 2) + ([1] * 3 + [0] * 37)
    pres = [PA.ExperimentResult(**dataclasses.asdict(r)) for r in jres]
    return jres, pres


def _evaluation(mod, results, n_eval):
    ev = mod.AblationEvaluator(results, "vqa_accuracy", n_eval=n_eval)
    an = mod.AblationAnalyzer(ev)
    return {"ranking": [r.experiment_id for r in ev.ranking()],
            "importance": [dataclasses.asdict(i)
                           for i in ev.expert_importance()],
            "deltas": ev.deltas_from_baseline(),
            "noise_floor": ev.noise_floor(),
            "paired": ev.paired_comparisons(),
            "contributions": [dataclasses.asdict(c)
                              for c in an.expert_contributions()],
            "synergies": [dataclasses.asdict(s)
                          for s in an.pairwise_synergies()],
            "findings": an.generate_key_findings(),
            "recommendation": dataclasses.asdict(an.recommendation())}


@pytest.mark.parametrize("n_eval", [None, 100, 200, 20000])
@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_evaluator_analyzer_and_reports_match_jax(masks, n_eval, tmp_path):
    jres, pres = _both_results(masks)
    assert _evaluation(PA, pres, n_eval) == _evaluation(JA, jres, n_eval)
    for name, mod, res in (("jax", JA, jres), ("port", PA, pres)):
        ev = mod.AblationEvaluator(res, "vqa_accuracy", n_eval=n_eval)
        mod.AblationReporter(ev, mod.AblationAnalyzer(ev),
                             lambda i: f"{i}:e{i}").save_all_reports(
            tmp_path / name)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == 6
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_statistics_match_jax():
    for b, c in ((0, 0), (3, 3), (10, 0), (4, 1), (1, 4), (40, 25)):
        assert PEV.mcnemar_exact_p(b, c) == JEV.mcnemar_exact_p(b, c)
        for n in (100, 204):
            assert PEV.discordant_delta_ci(b, c, n) == \
                JEV.discordant_delta_ci(b, c, n)
    for k, n in ((0, 10), (10, 10), (5, 10), (168, 204)):
        assert PEV.clopper_pearson(k, n) == JEV.clopper_pearson(k, n)


def test_mask_consistency_check_matches_jax():
    class _Log:
        def __init__(self):
            self.warned = []

        def warning(self, msg, *a):
            self.warned.append(msg % a if a else msg)

    good, bad = [1] * 82 + [0] * 18, [1] * 44 + [0] * 56
    for mod in (JA, PA):
        t = mod.AblationTrainer.__new__(mod.AblationTrainer)
        t.log = _Log()
        assert t.check_mask_consistency(good, 0.82, "x") is True
        assert t.check_mask_consistency(bad, 0.82, "x") is False
        assert "DISCARDING" in t.log.warned[0]
        assert t.check_mask_consistency(None, 0.82) is True


def test_cli_takes_every_jax_flag_and_device():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    want = flags(JRUN.build_argparser())
    got = flags(PRUN.build_argparser())
    assert got == want | {"--device"}
    assert PRUN.build_argparser().parse_args([]).device == "cuda"


# -- gradient accumulation ---------------------------------------------------
class _Two(torch.nn.Module):
    """Two Dense layers in f32: flax paths a/kernel, a/bias, b/kernel,
    b/bias, so the decay mask leaves the biases out on both sides."""

    def __init__(self):
        super().__init__()
        self.a = Dense(3, 4, dtype=torch.float32)
        self.b = Dense(4, 2, dtype=torch.float32)


@pytest.mark.parametrize("k", [2, 4])
def test_accumulation_matches_optax_multisteps(k):
    """3k micro-steps of random gradients (some leaves without a gradient
    on some steps, which optax sees as zeros) through the port's
    optimizer and through optax.MultiSteps over clip + AdamW +
    warmup-cosine: the parameters after every micro-step agree to 1e-5,
    stay put between updates (and at the first, whose warmup lr is 0),
    and the schedule's count advances once per k micro-steps."""
    rs = np.random.RandomState(0)
    params = {"a": {"kernel": rs.randn(3, 4).astype(np.float32),
                    "bias": rs.randn(4).astype(np.float32)},
              "b": {"kernel": rs.randn(4, 2).astype(np.float32),
                    "bias": rs.randn(2).astype(np.float32)}}
    opt_cfg = dict(learning_rate=1e-2, grad_clip_norm=1.0,
                   weight_decay=0.1, accumulate_steps=k)
    sched = dict(name="warmup_cosine", warmup_steps=1, total_steps=3)
    tx = JO.create_optimizer(JO.OptimizerConfig(**opt_cfg),
                             JO.SchedulerConfig(**sched), params=params)
    jstate = tx.init(params)
    jparams = params
    model = _Two()
    with torch.no_grad():
        for name in ("a", "b"):
            getattr(model, name).weight.copy_(
                torch.from_numpy(params[name]["kernel"].T))
            getattr(model, name).bias.copy_(
                torch.from_numpy(params[name]["bias"]))
    opt = PO.create_optimizer(PO.OptimizerConfig(**opt_cfg), model,
                              PO.SchedulerConfig(**sched))
    for step in range(3 * k):
        grads = jax.tree.map(
            lambda p: (3.0 * rs.randn(*p.shape)).astype(np.float32), params)
        if step % 3 == 1:       # b's bias gets no gradient this step
            grads["b"]["bias"] = np.zeros(2, np.float32)
        updates, jstate = tx.update(grads, jstate, jparams)
        before = [p.detach().clone() for p in model.parameters()]
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for name in ("a", "b"):
            lin = getattr(model, name)
            lin.weight.grad = torch.from_numpy(grads[name]["kernel"].T.copy())
            if not (name == "b" and step % 3 == 1):
                lin.bias.grad = torch.from_numpy(grads[name]["bias"].copy())
        norm = opt.step()
        assert_close(norm, optax.global_norm(grads), atol=1e-5, rtol=1e-5)
        for name in ("a", "b"):
            lin = getattr(model, name)
            assert_close(lin.weight.detach().T, jparams[name]["kernel"],
                         atol=1e-5, rtol=1e-5, msg=f"{name} step {step}")
            assert_close(lin.bias, jparams[name]["bias"], atol=1e-5,
                         rtol=1e-5, msg=f"{name} step {step}")
        moved = any(not torch.equal(p, b)
                    for p, b in zip(model.parameters(), before))
        assert moved == ((step + 1) % k == 0 and step + 1 > k), step
        assert opt.count == (step + 1) // k


def test_pipeline_spreads_its_schedule_over_the_updates():
    """training_pipeline.py:100 of the JAX package: with accumulation the
    schedule spans steps * epochs // k updates; a run of 6 steps at k = 2
    makes 3 updates."""
    model = _Two()
    cfg = PTP.TrainingPipelineConfig(
        num_epochs=3, optimizer=PO.OptimizerConfig(accumulate_steps=2))
    state = PTP.TrainingPipeline(cfg)._build_state(model, 4)
    want = JO.create_schedule(JO.SchedulerConfig(total_steps=6),
                              cfg.optimizer.learning_rate)
    for i in range(8):
        np.testing.assert_allclose(state.schedule(i), float(want(i)),
                                   rtol=1e-5, atol=1e-12)


# -- the trainer, runner and CLI on the CPU -----------------------------------
def _corpus(tmp_path, n=40, generative=False):
    csv, imgs = generate_synthetic_vivqa(tmp_path / "d", n=n, image_size=16,
                                         seed=0, learnable=True)
    data = DataPipeline(DataPipelineConfig(
        csv_path=str(csv), image_dir=str(imgs), image_size=16,
        max_question_length=8, max_answer_length=6, batch_size=8,
        augmentation_strength="light", generative=generative)).run()
    return csv, imgs, data


def _tiny(tok, generative=False):
    vis = PC.VisualEncoderConfig(image_size=16, patch_size=8, hidden_dim=32,
                                 num_layers=1, num_heads=2)
    txt = PC.TextEncoderConfig(vocab_size=tok.vocab_size, hidden_dim=32,
                               num_layers=1, num_heads=2, max_length=8)
    moe = PC.MoEModelConfig(use_moe=True, moe_type="vqa",
                            router_type="noisy_topk", num_vision_experts=1,
                            num_text_experts=0, num_multimodal_experts=1,
                            num_specialized_experts=1, expert_hidden_dim=32)
    if generative:
        return PC.GenerativeVQAConfig(
            visual=vis, text=txt, fusion_dim=32, fusion_layers=1,
            fusion_heads=2, vocab_size=tok.vocab_size, decoder_layers=1,
            decoder_heads=2, decoder_dim=32, decoder_ff_dim=64, moe=moe,
            bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id, max_answer_length=6)
    return PC.VQAModelConfig(
        visual=vis, text=txt,
        fusion=PC.FusionConfig(fusion_type="concat", hidden_dim=32,
                               num_heads=2, num_layers=1),
        moe=moe)


def test_runner_trains_post_hoc_rows_and_resumes(tmp_path, monkeypatch):
    """full, no_moe, a single-expert row and its post-hoc twin on the
    concat fusion and a 3-expert VQA-MoE: all complete with telemetry and
    a mask that agrees with exact match; the post-hoc row's router uses
    its one expert; reports, manifest, progress and per-epoch CSVs are
    written; a second run trains nothing."""
    _, _, data = _corpus(tmp_path)
    cfg = PA.AblationConfig(
        search=PA.AblationSearchSpace(num_experts=3,
                                      include_leave_one_out=False,
                                      include_single_expert=True,
                                      post_hoc_masks=True),
        num_epochs=1, batch_size=8, learning_rate=5e-3,
        primary_metric="exact_match", output_dir=str(tmp_path / "abl"))
    trainer = PA.AblationTrainer(cfg, _tiny(data.tokenizer), data, "cpu")
    runner = PA.AblationRunner(cfg, trainer)
    ids = [e.experiment_id for e in cfg.generate_experiment_matrix()]
    assert ids[3] == "ph_single_expert_0__noisy_topk_k2_lb0.01"
    results = runner.run(selected=[0, 1, 2, 3])
    by_id = {r.experiment_id: r for r in results}
    assert all(r.status == "completed" for r in results), \
        {r.experiment_id: r.error for r in results}
    n_val = len(data.val_loader.dataset)
    for r in results:
        assert r.moe_metrics is not None and len(r.correct_mask) == n_val
        assert abs(np.mean(r.correct_mask)
                   - r.metrics["exact_match"]) <= 0.02
    assert by_id["ph_single_expert_0__noisy_topk_k2_lb0.01"].moe_metrics[
        "num_active_experts"] == 1
    assert by_id[ids[0]].moe_metrics["num_active_experts"] >= 2
    out = tmp_path / "abl"
    for f in ("reports/report.md", "reports/results.csv", "reports/table.tex",
              "reports/analysis.json", "manifest.json", "progress.json",
              f"epoch_results/{ids[0]}/val_history.csv",
              f"epoch_results/{ids[0]}/train_history.csv"):
        assert (out / f).exists(), f
    ran = []
    run_experiment = PA.AblationTrainer.run_experiment
    monkeypatch.setattr(PA.AblationTrainer, "run_experiment",
                        lambda self, e: ran.append(e) or run_experiment(
                            self, e))
    again = runner.run(selected=[0, 1, 2, 3])
    assert not ran and sorted(r.experiment_id for r in again) == sorted(by_id)


def test_out_of_memory_retries_with_doubled_accumulation(tmp_path,
                                                          monkeypatch):
    _, _, data = _corpus(tmp_path, n=24)
    cfg = PA.AblationConfig(search=PA.AblationSearchSpace(num_experts=3),
                            num_epochs=1, batch_size=8,
                            output_dir=str(tmp_path / "abl"))
    trainer = PA.AblationTrainer(cfg, _tiny(data.tokenizer), data, "cpu")
    seen = []
    build_and_run = PA.AblationTrainer._build_and_run

    def flaky(self, experiment, accumulate):
        seen.append(accumulate)
        if len(seen) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return build_and_run(self, experiment, accumulate)
    monkeypatch.setattr(PA.AblationTrainer, "_build_and_run", flaky)
    r = trainer.run_experiment(cfg.generate_experiment_matrix()[0])
    assert seen == [1, 2] and r.status == "completed", r.error


def test_generative_experiment_completes(tmp_path):
    """One generative experiment (full): the greedy decode's per-sample
    exact match is its mask."""
    _, _, data = _corpus(tmp_path, generative=True)
    cfg = PA.AblationConfig(search=PA.AblationSearchSpace(num_experts=3),
                            model_type="generative", num_epochs=1,
                            batch_size=8, primary_metric="bleu",
                            output_dir=str(tmp_path / "abl"))
    trainer = PA.AblationTrainer(cfg, _tiny(data.tokenizer, True), data,
                                 "cpu")
    r = PA.AblationRunner(cfg, trainer).run(selected=[0])[0]
    assert r.status == "completed", r.error
    assert r.moe_metrics and "expert_usage" in r.moe_metrics
    assert len(r.correct_mask) == len(data.val_loader.dataset)
    assert r.metrics["n_eval"] == len(data.val_loader.dataset)


def test_cli_trains_resumes_reports_and_dry_runs(tmp_path, monkeypatch):
    csv, imgs, _ = _corpus(tmp_path)
    study = tmp_path / "study.yaml"
    PA.AblationConfig(
        search=PA.AblationSearchSpace(num_experts=6,
                                      include_single_expert=False,
                                      router_types=("noisy_topk", "soft")),
        num_epochs=1, batch_size=8, primary_metric="exact_match",
        output_dir=str(tmp_path / "out")).to_yaml(study)
    argv = ["--config", str(study), "--csv-path", str(csv), "--image-dir",
            str(imgs), "--image-size", "16", "--patch-size", "8",
            "--hidden-dim", "32", "--num-layers", "1",
            "--expert-hidden-dim", "32", "--specialized-experts", "6",
            "--vision-experts", "0", "--text-experts", "0",
            "--multimodal-experts", "0", "--device", "cpu"]
    tables = []

    class _Log:
        def section(self, title):
            pass

        def table(self, headers, rows):
            tables.append(rows)
    with monkeypatch.context() as mp:
        mp.setattr(PRUN, "get_pipeline_logger", _Log)
        assert PRUN.main(argv + ["--dry-run"]) is None
    assert [r[1] for r in tables[0]][-1] == "full__soft_k0_lb0.01"
    assert not (tmp_path / "out").exists()
    results = PRUN.main(argv + ["--experiments", "0,1"])
    assert [r.status for r in results] == ["completed"] * 2
    again = PRUN.main(argv + ["--experiments", "0,1"])
    assert sorted(r.experiment_id for r in again) == \
        sorted(r.experiment_id for r in results)
    files = PRUN.main(argv + ["--report-only"])
    assert set(files) == {"report", "csv", "latex", "analysis"}
    manifest = json.loads(Path(tmp_path / "out" / "manifest.json").read_text())
    assert manifest["num_experiments"] == 9
