"""The port's spans and counters (``utils/profiling.py``) on the CPU: off
and free outside a profiler, nested by time inside one, counting the
decoder's rows, and leaving the step's numbers as they were."""

from __future__ import annotations

import contextlib
import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_support import gen_config, gen_inputs, moe, small_cls_config, t
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.layers import init_weights
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.train import trainer as PT
from vivqa_tpu_torch.train.losses import IGNORE_INDEX
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (TrainState, classification_loss_fn,
                                         generative_loss_fn, make_train_step)
from vivqa_tpu_torch.utils import profiling

B = 3
PARTS = {"classification": ["vision", "text", "fusion", "moe", "head"],
         "generative": ["vision", "text", "fusion", "decoder"]}


def _cls_case():
    cfg = small_cls_config(PC).replace(moe=PC.MoEModelConfig(
        use_moe=True, num_experts=2, top_k=1, expert_hidden_dim=32))
    model = VietnameseVQAModel(cfg)
    rs = np.random.RandomState(0)
    mask = np.ones((B, 8), np.int64)
    mask[1, 5:] = 0
    batch = {"pixel_values": t(rs.standard_normal((B, 16, 16, 3))
                               .astype(np.float32)),
             "input_ids": t(rs.randint(4, 50, (B, 8)) * mask),
             "attention_mask": t(mask),
             "labels": t(rs.randint(0, 10, B))}
    return model, batch, classification_loss_fn()


def _gen_case():
    model = GenerativeVQAModel(gen_config(PC, moe=moe("fusion", PC)))
    px, q, qmask, dec, dmask = gen_inputs()
    labels = np.where(dmask.astype(bool), np.roll(dec, -1, axis=1),
                      IGNORE_INDEX)
    batch = {"pixel_values": t(px), "question_ids": t(q),
             "question_mask": t(qmask), "decoder_input_ids": t(dec),
             "decoder_mask": t(dmask), "labels": t(labels)}
    return model, batch, generative_loss_fn()


CASES = {"classification": _cls_case, "generative": _gen_case}


def _state(case: str, seed: int = 0):
    """A tiny model of ``case`` with seeded weights, its AdamW with
    clipping, a train state and one batch."""
    model, batch, loss_fn = CASES[case]()
    init_weights(model, torch.Generator().manual_seed(seed))
    opt = create_optimizer(OptimizerConfig(name="adamw", learning_rate=1e-3,
                                           grad_clip_norm=0.5), model,
                           SchedulerConfig(warmup_steps=1, total_steps=10))
    return (TrainState.create(model, opt, seed=seed), batch,
            make_train_step(loss_fn))


def _spans(prof) -> list:
    """(name, start, end) of the trace's ``vivqa::`` annotations, by
    start."""
    spans = ((e.name()[len("vivqa::"):], e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith("vivqa::"))
    return sorted(spans, key=lambda s: s[1])


def _inside(spans: list, outer: tuple) -> list:
    """The names of the spans directly inside ``outer``, in order."""
    within = [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
              and s != outer]
    return [s[0] for s in within
            if not any(o[1] <= s[1] and s[2] <= o[2] and o != s
                       for o in within)]


def _one(spans: list, name: str) -> tuple:
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_span_is_a_shared_null_context_outside_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("forward")
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.span("backward") is off
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        assert isinstance(profiling.span("forward"),
                          torch.profiler.record_function)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("forward") is off


@pytest.mark.parametrize("case", ["classification", "generative"])
def test_train_step_spans_nest_in_order(case):
    state, batch, step = _state(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = _spans(prof)
    assert not any(s[0].startswith(("cu", "Memcpy", "Memset"))
                   for s in spans)
    top = _one(spans, "train_step")
    assert _inside(spans, top) == ["forward", "backward", "optimizer"]
    assert _inside(spans, _one(spans, "forward")) == ["model", "loss"]
    assert _inside(spans, _one(spans, "model")) == PARTS[case]
    assert _inside(spans, _one(spans, "optimizer")) == [
        "grad_norm", "clip", "update"]
    if case == "generative":
        assert _inside(spans, _one(spans, "fusion")) == ["moe"]


def test_counters_count_the_decoder_rows_only_under_a_profiler():
    state, batch, step = _state("generative")
    profiling.reset_counters()
    step(state, batch)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
        profiling.count("decoder.positions", 5)
    got = profiling.counters()
    rows, L = batch["labels"].shape
    assert got == {"decoder.positions": rows * L + 5,
                   "decoder.labelled": int((batch["labels"]
                                            != IGNORE_INDEX).sum())}
    assert 0 < got["decoder.labelled"] < rows * L
    profiling.reset_counters()
    assert profiling.counters() == {}


@pytest.mark.parametrize("case", ["classification", "generative"])
def test_profiled_step_is_bit_equal(case):
    plain, batch, step = _state(case)
    traced = copy.deepcopy(plain)
    losses = [step(plain, batch)[1]["loss"]]
    with profile(activities=[ProfilerActivity.CPU]):
        losses.append(step(traced, batch)[1]["loss"])
    profiling.reset_counters()
    assert torch.equal(*losses)
    for (n, a), b in zip(plain.model.named_parameters(),
                         traced.model.parameters()):
        assert torch.equal(a, b), n


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


def test_trainer_profile_shows_data_wait_and_checkpoint(tmp_path):
    model = VietnameseVQAModel(small_cls_config(PC))
    init_weights(model, torch.Generator().manual_seed(0))
    _, batch, _ = _cls_case()
    batches = [{k: v.numpy() for k, v in batch.items()}] * 3
    cfg = PT.TrainerConfig(num_epochs=1, log_every=10, resume=False,
                           checkpoint_dir=str(tmp_path / "ck"),
                           profile_steps=(0, 99),
                           profile_dir=str(tmp_path / "prof"),
                           optimizer=OptimizerConfig(name="sgd"))
    trainer = PT.VQATrainer(cfg, model, device="cpu")
    out = trainer.train(_Loader(batches))
    assert out["state"].step == 3
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    # the profile runs from step 0 to the end of training: three steps,
    # the fetches after each (the last finds the loader done) and the
    # epoch's save
    assert names.count("vivqa::train_step") == 3
    assert names.count("vivqa::loss") == 3
    assert names.count("vivqa::data_wait") == 3
    assert names.count("vivqa::checkpoint") == 1
