"""The port's two bench entry points on the CPU: their inputs are the root
scripts', their measurement loops count and report what they say, and
they refuse to run without a card (the numbers are the card's only)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_support import gen_config
from vivqa_tpu_torch import bench, bench_serving
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.decoding import build_generate_fn
from vivqa_tpu_torch.models.generative import create_generative_vqa_model
from vivqa_tpu_torch.train.state import (TrainState, classification_loss_fn,
                                         make_train_step)
from vivqa_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_serving_inputs_are_the_root_scripts():
    """bench_serving.py:236-239 and its config at :212-222."""
    cfg = bench_serving.serving_config()
    px, q = bench_serving.synthetic_requests(cfg, 3)
    np.testing.assert_array_equal(
        px, np.random.RandomState(0).rand(3, 224, 224, 3).astype(np.float32))
    np.testing.assert_array_equal(
        q, np.random.RandomState(1).randint(0, 64000, (3, 64)))
    assert (cfg.decoder_layers, cfg.decoder_dim, cfg.fusion_layers,
            cfg.vocab_size, cfg.max_answer_length, cfg.dtype) == (
        6, 512, 3, 64001, 32, "bfloat16")
    dc = bench_serving.decode_config("beam")
    assert (dc.max_length, dc.num_beams, dc.early_exit) == (32, 4, False)


def test_training_inputs_are_the_root_scripts():
    """bench.py:75-83."""
    data = bench.synthetic_batch(bench.flagship_config(), 2, "cpu")
    np.testing.assert_array_equal(
        data["pixel_values"].numpy(),
        np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32))
    np.testing.assert_array_equal(
        data["input_ids"].numpy(),
        np.random.RandomState(1).randint(0, 64000, (2, 64)))
    np.testing.assert_array_equal(
        data["labels"].numpy(), np.random.RandomState(2).randint(0, 1000, 2))
    assert bool((data["attention_mask"] == 1).all())


def test_bench_one_counts_its_calls():
    cfg = gen_config(PC)
    model = create_generative_vqa_model(cfg, device="cpu")
    gen = build_generate_fn(model, bench_serving.decode_config("greedy", 4))
    calls = []

    def counted(*args):
        calls.append(1)
        return gen(*args)
    px, q = bench_serving.synthetic_requests(cfg, 2)
    res, (seqs, scores) = bench_serving.bench_one(
        counted, (torch.from_numpy(px), torch.from_numpy(q)), 2, windows=3,
        iters=2, lat_calls=4)
    assert len(calls) == 1 + 3 * 2 + 4
    assert seqs.shape == (2, 4) and torch.isfinite(scores).all()
    assert set(res) == {"answers_per_sec", "device_ms_per_batch",
                        "window_spread_pct", "latency_ms_p50",
                        "latency_ms_p95"}
    assert res["answers_per_sec"] == pytest.approx(
        2e3 / res["device_ms_per_batch"])
    assert res["latency_ms_p50"] <= res["latency_ms_p95"]


def test_time_train_steps_on_cpu():
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=32, patch_size=16,
                                      hidden_dim=32, num_layers=1,
                                      num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=100, hidden_dim=32,
                                  num_layers=1, num_heads=2, max_length=8),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=32,
                               num_heads=2, num_layers=1),
        num_answers=16)
    from vivqa_tpu_torch.models.vqa_model import create_vqa_model
    model = create_vqa_model(cfg, device="cpu")
    state = TrainState.create(model, bench.bench_optimizer(model), seed=0)
    host_ms, event_ms, metrics = profiling.time_train_steps(
        make_train_step(classification_loss_fn()), state,
        bench.synthetic_batch(cfg, 2, "cpu"), steps=2)
    assert len(host_ms) == len(metrics) == 2 and event_ms == []
    assert state.step == 2


def test_bench_flops_count():
    """bench.py:133-154 at the flagship config, evaluated here line for
    line from the config's fields: 6 x the forward's multiply-adds,
    linear in the batch."""
    cfg = bench.flagship_config()

    def tower_macs(tokens, d, layers):
        return tokens * layers * (12 * d * d + 2 * tokens * d)

    L_v = (cfg.visual.image_size // cfg.visual.patch_size) ** 2 + 1
    L_t = cfg.text.max_length
    d_f = cfg.fusion.hidden_dim
    macs = (tower_macs(L_v, cfg.visual.hidden_dim, cfg.visual.num_layers)
            + L_v * 3 * cfg.visual.patch_size ** 2 * cfg.visual.hidden_dim
            + tower_macs(L_t, cfg.text.hidden_dim, cfg.text.num_layers)
            + tower_macs(L_t, d_f, cfg.fusion.num_layers)
            + tower_macs(L_v, d_f, cfg.fusion.num_layers)
            + cfg.fusion.num_layers * L_v * (4 * d_f * d_f + 2 * L_t * d_f)
            + (L_v + L_t) * cfg.moe.num_experts
            * 2 * d_f * cfg.moe.expert_hidden_dim
            + d_f * cfg.num_answers)
    assert bench.train_step_flops(cfg, 128) == 6.0 * macs * 128
    assert bench.train_step_flops(cfg, 256) == 2 * bench.train_step_flops(
        cfg, 128)
    # the flagship's numbers: L_v = 50, L_t = 64, 12 x 768 towers,
    # 4 x 512 MCAN, 4 experts of 1,024: 12.086e9 MACs a QA pair
    assert bench.train_step_flops(cfg, 128) == pytest.approx(9.2813e12,
                                                             rel=1e-4)


def test_entry_points_need_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serving.main()
    # the fitted mode (a checkpoint reader since it was ported) asks for
    # the card before it reads anything
    monkeypatch.setenv("BENCH_SERVE_CKPT", "/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serving.main()
