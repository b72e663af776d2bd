"""The decoder-only Kimi-VL cell at tiny widths on the CPU: the
benchmark's reference copy against the port, the cell found by name and
run through the train driver, its product count on the meta device and
its two counter metrics from a traced run."""

import copy
import json
import math
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import counts, harness, run
from benchmark.reference.layers import Precision
from benchmark.reference.train import decays, leaf_norms, loss_and_grads
from benchmark.tests.tiny_cells import tiny_bench
from benchmark.traffic import make_ring
from benchmark.weights import load, make_weights
from vivqa_tpu_torch.train.optimizers import decay_mask
from vivqa_tpu_torch.train.state import generative_loss_fn
from vivqa_tpu_torch.utils import profiling

SEED = 2 ** 31 + 41
CELL = "kimivl-train-b512"
# the tiny cell's own limits: the bf16 program at width 64 on the CPU
# against the f32 reference (sound runs read loss 2-4e-3, grad and change
# gaps under 0.1; routing flips on near ties move single expert leaves)
LIMITS = {"loss_gap": 2e-2, "grad_gap": 0.5, "change_gap": 0.5}


def tiny(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["visual"].update(image_size=32, patch_size=16, hidden_dim=64,
                         num_layers=1, num_heads=4)
    cfg.update(vocab_size=64, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=2, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=16,
               experts_held=[0, 8], num_experts_per_tok=3,
               n_shared_experts=1, max_question_length=12,
               max_answer_length=8, bias_fit_samples=3,
               bias_update_iterations=2)
    return cfg


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark's data files with a ``tiny-kimivl-train-b512`` cell
    beside them."""
    d = tiny_bench(tmp_path_factory.mktemp("tiny"))
    w = json.loads((d / "workloads" / f"{CELL}.json").read_text())
    c = json.loads((d / "configs" / f"{w['config']}.json").read_text())
    c["config"] = tiny(c["config"])
    (d / "configs" / f"tiny-{w['config']}.json").write_text(json.dumps(c))
    t = json.loads((d / "traffic" / f"{w['traffic']}.json").read_text())
    t["batch"] = 8
    for f in t["fields"]:
        if f["kind"] == "question":
            f["length"] = [3, 12]
    (d / "traffic" / f"tiny-{w['traffic']}.json").write_text(json.dumps(t))
    w.update(config=f"tiny-{w['config']}", traffic=f"tiny-{w['traffic']}",
             reference_block=3, limits=LIMITS)
    (d / "workloads" / f"tiny-{CELL}.json").write_text(json.dumps(w))
    return d


def as_f32(model):
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    return model


def test_reference_loss_and_gradients_match_port(bench):
    """In float32 the port and the reference agree to rounding: the
    same sequences, routing, loss over the labelled rows and every
    gradient (the reference in blocks of 3 rows)."""
    cell = harness.load_cell(f"tiny-{CELL}", bench)
    cfg = cell.model_config
    shapes = harness.parameter_shapes(cell)
    model = as_f32(harness.program_model(cell, "cpu")).train()
    load(model, make_weights(shapes, SEED, "cpu"))
    ref = harness.reference_module(cell).Model(cfg, Precision())
    load(ref, make_weights(shapes, SEED, "cpu"))
    batch = make_ring(cell.traffic, cfg, SEED, "cpu")[0]
    loss, _ = generative_loss_fn(0.1, 0.0)(model, batch, torch.Generator())
    loss.backward()
    value, grads = loss_and_grads(ref, batch, torch.Generator(),
                                  {"label_smoothing": 0.1,
                                   "aux_weight": 0.0}, block=3)
    assert value == pytest.approx(float(loss.detach()), rel=1e-5)
    norms = leaf_norms(grads)
    floor = 1e-3 * statistics.median(norms)
    params = dict(model.named_parameters())
    checked = 0
    for (name, _), g, gn in zip(ref.named_parameters(), grads, norms):
        if gn < floor:      # nought but rounding (a key bias, ln_final)
            continue
        assert float((params[name].grad - g).norm()) <= 1e-4 * gn, name
        checked += 1
    assert checked > 0.9 * len(norms)


def test_decay_rule_matches_port(bench):
    model = harness.program_model(harness.load_cell(f"tiny-{CELL}", bench),
                                  "cpu")
    mask = decay_mask(model)
    assert {n: decays(n) for n, _ in model.named_parameters()} == mask
    assert not mask["layers.1.ln_attn.weight"]
    assert not mask["token_embed.weight"]
    assert mask["layers.1.moe.experts_w_gate"] and mask["lm_head.weight"]


def test_tiny_cell_runs_through_the_train_driver(bench):
    profiling.reset_counters()
    out = run.run_cell(f"tiny-{CELL}", SEED, 0.3, False, "cpu", 0.0,
                       bench_dir=bench, root=bench.parent)
    assert out["correct"] is True, out["check"]
    assert out["metrics"]["train_samples_per_s"]["value"] > 0
    assert set(out["check"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_traced_run_reports_the_counter_metrics(bench):
    """Every held assignment runs as one row (100%), and the busiest of
    the 8 held experts takes more than an even share."""
    profiling.reset_counters()
    out = run.run_cell(f"tiny-{CELL}", SEED, 0.3, True, "cpu", 0.0,
                       bench_dir=bench, root=bench.parent)
    c = profiling.counters()
    profiling.reset_counters()
    m = out["metrics"]
    assert out["correct"] is True, out["check"]
    assert m["expert_rows_useful_pct.train"]["value"] == 100.0
    assert 100.0 < m["moe_load_peak_pct.train"]["value"] <= 800.0
    assert m["moe_load_peak_pct.train"]["value"] == pytest.approx(
        100.0 * c["moe.held_peak"] / c["moe.held"])
    # 4 traced steps x 2 MoE layers x the batch's real tokens x k
    assert 0 < c["moe.held"] < c["moe.routed"]
    # the labelled rows are all the head projects, as in the flagship
    assert m["answer_rows_useful_pct.train"]["value"] == 100.0


def test_counter_metrics_read_nothing_without_counters():
    profiling.reset_counters()
    for name in ("expert_rows_useful_pct.train", "moe_load_peak_pct.train"):
        assert harness.metric_reader(name, harness.BENCH_DIR)({}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("moe.held", torch.tensor(300))
        profiling.count("moe.expert_rows", 300)
        profiling.count("moe.held_peak", 8 * 60)
    read = harness.metric_reader("moe_load_peak_pct.train",
                                 harness.BENCH_DIR)
    assert read({}) == pytest.approx(160.0)
    profiling.reset_counters()


def test_meta_count_of_the_published_step():
    """The step's products at the published widths, batch 512: the
    towers, MLA, the dense layer, the shared experts and the router on
    all 145 positions, each held expert on its even share of the real
    tokens' assignments, the head on the labelled rows; ~115 TFLOP."""
    cell = harness.load_cell(CELL)
    t = dict(cell.traffic, ring=1)
    batch = make_ring(t, cell.model_config, SEED, "cpu")[0]
    c = counts.model_counts(harness.reference_module(cell),
                            cell.model_config, batch,
                            harness.mask_fields(t), True,
                            {"label_smoothing": 0.1})
    assert 114e12 < c["flops"] < 116.5e12
    assert len(c["attention"]) == 12        # the tower's; MLA records none
    n_params = sum(math.prod(s) for _, s in harness.parameter_shapes(cell))
    assert n_params == cell.config["parameters"] == 658108160


def test_three_float32_steps_match_the_reference(bench):
    """The port's train step and the reference's, in float32, over three
    steps from the same weights and batches: the first step fits the
    routing bias once on its first samples (the reference's first
    block), and each later step first moves it on from its own, so the
    losses and every parameter's change agree to rounding."""
    from benchmark.drivers.train import program_step
    from benchmark.reference.train import train_steps
    from vivqa_tpu_torch.train.state import TrainState
    cell = harness.load_cell(f"tiny-{CELL}", bench)
    cfg = cell.model_config
    shapes = harness.parameter_shapes(cell)
    model = as_f32(harness.program_model(cell, "cpu"))
    load(model, make_weights(shapes, SEED, "cpu"))
    ref = harness.reference_module(cell).Model(cfg, Precision())
    load(ref, make_weights(shapes, SEED, "cpu"))
    ring = make_ring(dict(cell.traffic, ring=3), cfg, SEED, "cpu")
    optimizer, step = program_step(cell, model)
    state = TrainState.create(model, optimizer, seed=11)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(step(state, ring[i])[1]["loss"]) for i in range(3)]
    got = train_steps(ref, ring, 11, {"label_smoothing": 0.1,
                                      "aux_weight": 0.0},
                      cell.workload["optimizer"], 3)
    assert got["losses"] == pytest.approx(losses, rel=1e-5)
    floor = 1e-3 * statistics.median(got["first_grad"].values())
    for n, p in model.named_parameters():
        if got["first_grad"][n] > floor:
            change = float((p.detach() - start[n]).norm())
            assert change == pytest.approx(got["change"][n], rel=2e-3), n
