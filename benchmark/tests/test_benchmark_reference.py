"""The plain reference at tiny widths against the port's CPU path.

The port computes MCAN, the answer head's hidden layer and the towers in
bfloat16 by construction; here every module's compute type is set to
float32 after it is built, so the two sides do the same arithmetic and
agree to float32 rounding: the same dropout masks (elementwise and the
attention kernels' hash), the same MoE routing and load-balance loss,
the same label-smoothed loss. The reference takes its step in blocks of
rows; the blocks must not change it.
"""

import statistics

import pytest
import torch

from benchmark import harness
from benchmark.reference.layers import Precision, fold_in
from benchmark.reference.train import (AdamW, decays, leaf_norms,
                                       loss_and_grads, train_steps)
from benchmark.tests.tiny_cells import tiny_bench
from benchmark.traffic import make_ring, resolve
from benchmark.weights import load, make_weights
from vivqa_tpu_torch.train import state as port_state
from vivqa_tpu_torch.train.optimizers import decay_mask

SEED = 2 ** 31 + 5


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


def as_f32(model):
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    return model


def port_loss(cell):
    loss = cell.workload["loss"]
    return getattr(port_state, loss["function"])(**loss["kwargs"])


def pair(cell):
    cfg = cell.model_config
    shapes = harness.parameter_shapes(cell)
    model = as_f32(harness.program_model(cell, "cpu"))
    load(model, make_weights(shapes, SEED, "cpu"))
    ref = harness.reference_module(cell).Model(cfg, Precision())
    load(ref, make_weights(shapes, SEED, "cpu"))
    ring = make_ring(cell.traffic, cfg, SEED, "cpu")
    ref_loss = {k: resolve(v, cfg)
                for k, v in cell.workload.get("reference_loss", {}).items()}
    return model, ref, ring, ref_loss


@pytest.mark.parametrize("name", ["tiny-cls-train-b512",
                                  "tiny-gen-train-b512"])
def test_train_loss_and_gradients_match_port(bench, name):
    cell = harness.load_cell(name, bench)
    model, ref, ring, ref_loss = pair(cell)
    model.train()
    loss, _ = port_loss(cell)(model, ring[0],
                              torch.Generator().manual_seed(fold_in(7, 0)))
    loss.backward()
    loss = loss.detach()
    value, grads = loss_and_grads(
        ref, ring[0], torch.Generator().manual_seed(fold_in(7, 0)),
        ref_loss, block=3)
    assert value == pytest.approx(float(loss), rel=1e-5)
    norms = leaf_norms(grads)
    floor = 1e-3 * statistics.median(norms)
    checked = 0
    for (n, _), g, gn in zip(ref.named_parameters(), grads, norms):
        mine = dict(model.named_parameters())[n].grad
        if gn < floor:      # nought but rounding (a bias under softmax)
            continue
        assert mine is not None, n
        assert float((mine - g).norm()) <= 1e-4 * gn, n
        checked += 1
    assert checked > 0.8 * len(norms)


def test_blocks_do_not_change_the_step(bench):
    cell = harness.load_cell("tiny-cls-train-b512", bench)
    _, ref, ring, ref_loss = pair(cell)
    out = []
    for block in (8, 3):
        gen = torch.Generator().manual_seed(fold_in(9, 0))
        out.append(loss_and_grads(ref, ring[1], gen, ref_loss, block))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    scale = statistics.median(leaf_norms(out[0][1]))
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).norm()) <= 1e-5 * max(float(b.norm()), scale)


def test_eval_logits_match_port(bench):
    cell = harness.load_cell("tiny-cls-infer-b512", bench)
    model, ref, ring, _ = pair(cell)
    model.eval()
    with torch.no_grad():
        want = model(*[ring[0][a] for a in cell.workload["inputs"]])[
            "logits"]
        got = ref.logits(ring[0])[0]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_adamw_matches_port_optimizer(bench):
    """Three steps of the port's train step against the reference's, in
    float32, from the same weights, batches and dropout."""
    from benchmark.drivers.train import program_step
    cell = harness.load_cell("tiny-cls-train-b512", bench)
    model, ref, ring, ref_loss = pair(cell)
    optimizer, step = program_step(cell, model)
    state = port_state.TrainState.create(model, optimizer, seed=11)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(step(state, ring[i])[1]["loss"]) for i in range(3)]
    got = train_steps(ref, ring[:3], 11, ref_loss,
                      cell.workload["optimizer"], 3)
    assert got["losses"] == pytest.approx(losses, rel=1e-5)
    for n, p in model.named_parameters():
        change = float((p.detach() - start[n]).norm())
        if got["first_grad"][n] > 1e-3 * statistics.median(
                got["first_grad"].values()):
            assert change == pytest.approx(got["change"][n], rel=2e-3), n


def test_decay_rule_matches_port(bench):
    cell = harness.load_cell("tiny-cls-train-b512", bench)
    model = harness.program_model(cell, "cpu")
    assert {n: decays(n) for n, _ in model.named_parameters()} \
        == decay_mask(model)
    gcell = harness.load_cell("tiny-gen-train-b512", bench)
    gmodel = harness.program_model(gcell, "cpu")
    assert {n: decays(n) for n, _ in gmodel.named_parameters()} \
        == decay_mask(gmodel)


def test_adamw_schedule_starts_at_zero():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([("w", p)], {"learning_rate": 1e-4, "weight_decay": 0.01,
                             "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                             "grad_clip_norm": 1.0, "warmup_steps": 100,
                             "total_steps": 1000})
    opt.step([torch.full((3,), 5.0)])
    assert torch.equal(p.detach(), torch.ones(3))
    assert float(opt.mu[0][0]) == pytest.approx(0.1 * 5 / (
        5 * 3 ** 0.5), rel=1e-6)


def test_traffic_same_lengths_every_batch(bench):
    cell = harness.load_cell("tiny-gen-train-b512", bench)
    ring = make_ring(cell.traffic, cell.model_config, 123, "cpu")
    for batch in ring:
        q = batch["question_mask"].sum(1).sort().values
        assert torch.equal(q, ring[0]["question_mask"].sum(1).sort().values)
        ids, labels = batch["decoder_input_ids"], batch["labels"]
        n = batch["decoder_mask"].sum(1)
        assert int(n.min()) >= 2 and int(n.max()) <= 7
        for row in range(len(ids)):
            k = int(n[row]) - 1
            assert int(ids[row, 0]) == 0 and int(labels[row, k]) == 2
            assert torch.equal(ids[row, 1:k + 1], labels[row, :k])
            assert bool((labels[row, k + 1:] == -100).all())
    other = make_ring(cell.traffic, cell.model_config, 124, "cpu")
    assert not torch.equal(other[0]["question_ids"], ring[0]["question_ids"])
