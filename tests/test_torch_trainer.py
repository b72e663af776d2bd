"""``vivqa_tpu_torch/train/trainer.py`` (``VQATrainer``) against the JAX
package's trainer, and its own behaviour.

- Two steps of ``freeze_visual`` (SGD with momentum, so that an f32
  rounding of a gradient moves a weight by lr times that rounding, not
  by Adam's lr whatever the gradient): the loss and every parameter leaf
  match the JAX trainer to 1e-5 in f32, with both packages' forced-bf16
  modules (MCAN, AttFlat, the answer head) patched to f32 and every
  dropout at 0; the frozen visual encoder is bit-equal to its start.
- Gradient checkpointing gives the same loss and every gradient, bit for
  bit, as the plain forward with dropout on and the same generator; the
  generator's restore is what makes it so.
- ``gradual_unfreeze``: three stages, the whole state rebuilt at each
  change (moments at zero, count and step at 0), frozen leaves unchanged
  until their stage.
- Resume of the full state, the SIGINT checkpoint, the TensorBoard
  writer and the resource manager's lifecycle.
"""

from __future__ import annotations

import copy
import os
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_support import (as_f32, forced_bf16_as_f32, kept_prng_impl,
                                padding_mask, small_cls_config,
                                small_cls_params)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models import vqa_model as JVM
from vivqa_tpu.parallel import MeshConfig, create_mesh
from vivqa_tpu.train import trainer as JT
from vivqa_tpu.train.optimizers import OptimizerConfig as JOpt
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import (flatten_params,
                                             load_flax_params, to_flax)
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.resources import (BackupConfig, ReportIntervalConfig,
                                       ResourceConfig, ResourceManager)
from vivqa_tpu_torch.train import trainer as PT
from vivqa_tpu_torch.train.optimizers import OptimizerConfig as POpt
from vivqa_tpu_torch.train.state import fold_in

torch.set_num_threads(1)
B, S, L, A = 4, 16, 8, 10
TOL = 1e-5


def _config(mod, dropout: float = 0.0):
    return small_cls_config(mod, dropout)


def _batches(n: int = 2, seed: int = 0) -> list:
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = padding_mask(rs.randint(1, L + 1, B), L)
        out.append({"pixel_values": rs.standard_normal((B, S, S, 3)).astype(
                        np.float32),
                    "input_ids": (rs.randint(4, 50, (B, L)) * mask).astype(
                        np.int32),
                    "attention_mask": mask,
                    "labels": rs.randint(0, A, B).astype(np.int32)})
    return out


class _Loader:
    """Collated batches with a length, re-iterable, as a BatchLoader."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


@pytest.fixture(scope="module")
def params():
    return small_cls_params(_batches(1)[0])


def _port(params, dropout: float = 0.0):
    return as_f32(load_flax_params(VietnameseVQAModel(_config(PC, dropout)),
                                     params))


def _cfg(mod, tmp, **kw):
    opt = JOpt if mod is JT else POpt
    base = dict(num_epochs=1, log_every=1, resume=False,
                checkpoint_dir=str(tmp), early_stopping_patience=10,
                optimizer=opt(name="sgd", learning_rate=0.05,
                              weight_decay=0.01))
    base.update(kw)
    return mod.TrainerConfig(**base)


def test_freeze_visual_matches_the_jax_trainer(params, tmp_path):
    """Two steps of freeze_visual through both trainers from one init:
    the epoch's mean loss to 1e-5 relative, every leaf to 1e-5, the
    visual encoder bit-equal to its start."""
    loader = _Loader(_batches(2, seed=3))
    with forced_bf16_as_f32(), kept_prng_impl():
        jm = JVM.VietnameseVQAModel(_config(JC))
        mesh = create_mesh(MeshConfig(), devices=jax.devices("cpu")[:1])
        jout = JT.VQATrainer(_cfg(JT, tmp_path / "j",
                                  strategy="freeze_visual"),
                             jm, params, mesh).train(loader)
    model = _port(params)
    out = PT.VQATrainer(_cfg(PT, tmp_path / "p", strategy="freeze_visual"),
                        model, device="cpu").train(loader)
    np.testing.assert_allclose(out["history"][0]["train_loss"],
                               jout["history"][0]["train_loss"], rtol=TOL)
    assert out["state"].step == 2
    want = flatten_params(jax.device_get(jout["state"].params))
    got = to_flax(model, dict(model.named_parameters()),
                  {k: v.shape for k, v in want.items()})
    start = flatten_params(params)
    moved = 0
    for path, w in want.items():
        if path.startswith("visual_encoder/"):
            np.testing.assert_array_equal(got[path], start[path])
        else:
            np.testing.assert_allclose(got[path], np.asarray(w), atol=TOL,
                                       rtol=0, err_msg=path)
            moved += not np.array_equal(got[path], start[path])
    assert moved > 10


def _one_step_grads(model, checkpointing: bool, seed: int = 11):
    trainer = PT.VQATrainer(PT.TrainerConfig(
        gradient_checkpointing=checkpointing), model, device="cpu")
    b = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
         else torch.from_numpy(v) for k, v in _batches(1, seed=5)[0].items()}
    model.train()
    loss, _ = trainer._loss_fn()(model, b,
                                 torch.Generator().manual_seed(seed))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_gradient_checkpointing_replays_the_dropout(params):
    """With dropout 0.1 in the text encoder, MCAN and the head: the
    checkpointed step's loss and every gradient equal the plain step's
    bit for bit on the CPU; restoring the generator is what makes it so
    (a recompute that draws on would take other masks)."""
    plain = _port(params, dropout=0.1)
    ckpt = copy.deepcopy(plain)
    loss, grads = _one_step_grads(plain, False)
    closs, cgrads = _one_step_grads(ckpt, True)
    assert torch.equal(loss, closs)
    for n, g in grads.items():
        assert torch.equal(g, cgrads[n]), n

    naive = copy.deepcopy(ckpt)
    for p in naive.parameters():
        p.grad = None
    gen = torch.Generator().manual_seed(11)
    b = {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
         else torch.from_numpy(v) for k, v in _batches(1, seed=5)[0].items()}
    out = torch.utils.checkpoint.checkpoint(
        lambda *a: naive(*a, generator=gen), b["pixel_values"],
        b["input_ids"], b["attention_mask"], use_reentrant=False)
    torch.nn.functional.cross_entropy(out["logits"], b["labels"]).backward()
    assert any(not torch.equal(p.grad, grads[n])
               for n, p in naive.named_parameters() if p.grad is not None)


class _Recording(PT.VQATrainer):
    """Records, at each state built, the epoch's mask and a copy of the
    weights, and keeps every optimizer."""

    def _build_state(self, steps_per_epoch, epoch=0):
        state = super()._build_state(steps_per_epoch, epoch)
        self.built = getattr(self, "built", [])
        self.built.append({"epoch": epoch, "optimizer": state.optimizer,
                           "step": state.step, "count": state.optimizer.count,
                           "zero": all(not t.any() for ts in
                                       state.optimizer.state.values()
                                       for t in ts),
                           "weights": {n: p.detach().clone() for n, p in
                                       self.model.named_parameters()}})
        return state


def test_gradual_unfreeze_rebuilds_the_whole_state(params, tmp_path):
    """Three epochs of two steps: a state built at epochs 0, 1 and 2,
    each with zero moments, count 0 and step 0 (the schedule and the
    dropout stream restart); each stage's optimizer applied its two
    updates; the text encoder unchanged through epoch 0 and the visual
    encoder through epochs 0-1, both moved by the end."""
    model = _port(params)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = _Recording(_cfg(PT, tmp_path, num_epochs=3,
                              strategy="gradual_unfreeze",
                              optimizer=POpt(learning_rate=1e-2)),
                         model, device="cpu")
    out = trainer.train(_Loader(_batches(2)))
    assert [b["epoch"] for b in trainer.built] == [0, 1, 2]
    assert all(b["zero"] and b["count"] == 0 and b["step"] == 0
               for b in trainer.built)
    assert [b["optimizer"].count for b in trainer.built] == [2, 2, 2]
    assert out["state"].step == 2 and len(out["history"]) == 3
    assert out["state"].generator.initial_seed() == fold_in(42, 1)
    final = dict(model.named_parameters())
    for n, p in start.items():
        head = n.split(".")[0]
        if head == "visual_encoder":
            assert torch.equal(trainer.built[2]["weights"][n], p), n
        if head == "text_encoder":
            assert torch.equal(trainer.built[1]["weights"][n], p), n
    for head in ("visual_encoder", "text_encoder", "answer_head"):
        assert any(not torch.equal(final[n], start[n]) for n in start
                   if n.startswith(head)), head


def test_resume_restores_the_full_state(params, tmp_path):
    """A run of 2 epochs saves its state; a run of 4 with resume starts
    at epoch 2 with the saved optimizer (its count and moments) and step,
    and ends at step 4 x steps per epoch; the TensorBoard writer wrote
    its events."""
    loader = _Loader(_batches(2))
    cfg = _cfg(PT, tmp_path / "ck", num_epochs=2,
               optimizer=POpt(learning_rate=5e-3),
               tensorboard_dir=str(tmp_path / "tb"))
    first = PT.VQATrainer(cfg, _port(params), device="cpu").train(loader,
                                                                   loader)
    assert first["state"].step == 4
    saved = {n: p.detach().clone() for n, p in
             first["state"].model.named_parameters()}
    assert any(Path(tmp_path / "tb").iterdir())

    model = _port(params)
    trainer = _Recording(cfg.replace(num_epochs=4, resume=True,
                                     tensorboard_dir=""), model,
                         device="cpu")
    restored = []
    orig = trainer._restore_full

    def spy(ckpt, state):
        state, meta = orig(ckpt, state)
        restored.append((state.step, state.optimizer.count,
                         {n: p.detach().clone()
                          for n, p in model.named_parameters()},
                         [t.clone() for t in state.optimizer.state["mu"]]))
        return state, meta
    trainer._restore_full = spy
    out = trainer.train(loader, loader)
    step, count, weights, mus = restored[0]
    assert step == 4 and count == 4
    assert all(torch.equal(weights[n], p) for n, p in saved.items())
    assert any(m.abs().max() > 0 for m in mus)
    assert [h["epoch"] for h in out["history"]] == [2, 3]
    assert out["state"].step == 8 and out["state"].optimizer.count == 8


def test_sigint_saves_and_the_resource_manager_follows(params, tmp_path):
    """A SIGINT during the first epoch: the step finishes, a checkpoint
    marked interrupted is saved, training stops, and the resource
    manager (attached) records the failure with an emergency backup of
    the weights."""

    class Interrupting(_Loader):
        def __iter__(self):
            for i, b in enumerate(super().__iter__()):
                if i == 1:
                    os.kill(os.getpid(), signal.SIGINT)
                yield b

    rm = ResourceManager(ResourceConfig(
        backup=BackupConfig(emergency_dir=str(tmp_path / "em")),
        report=ReportIntervalConfig(report_dir=str(tmp_path / "rep")),
        enable_signal_handlers=False))
    cfg = _cfg(PT, tmp_path / "ck", num_epochs=3)
    before = signal.getsignal(signal.SIGINT)
    out = PT.VQATrainer(cfg, _port(params), device="cpu",
                        resource_manager=rm).train(Interrupting(_batches(3)))
    assert out["interrupted"] and len(out["history"]) == 1
    assert signal.getsignal(signal.SIGINT) is before
    from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                  CheckpointManager)
    state, meta = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "ck"))).restore()
    assert meta["interrupted"] and set(state) == {"params", "optimizer",
                                                 "step", "seed"}
    assert rm.progress.tasks["training"].status == "failed"
    backup = rm.backup.backups[-1]
    got = rm.backup.restore(backup, "trainer_state")
    assert set(got) == set(state["params"])
