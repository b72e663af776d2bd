"""Training state and the train/eval steps (counterpart of
vivqa_tpu/train/state.py).

The JAX package compiles one pure function ``state' = train_step(state,
batch)``; here the model and the optimizer update in place, eagerly. The
dropout randomness of step n comes from a ``torch.Generator`` reseeded
with ``fold_in(seed, n)`` before the step, as the JAX step folds the step
into ``state.rng``; reseeding is host-side and costs no device sync.

On a ('data', 'model') mesh (``parallel/mesh.py``), ``place_state``
keeps each rank's shard of the parameters and the optimizer's moments
and ``ShardedStep`` runs the global step: each rank takes its rows of the
global batch, the losses divide by the global counts, the optimizer
averages the gradients over 'data' (``train/optimizers.py``) and the
metrics come back equal on every rank. The step's loss, gradient norm
and update are the one-device step's up to the order of the sums. On
more than one 'data' rank, the dropout stream of step n is
``fold_in(fold_in(seed, n), data rank)``: the ranks draw different masks
and a rank repeats its own, but the masks are not the one-device masks'
rows (ROADMAP.md, Queue C). The JAX package's ``settled_*`` functions,
its TPU runtime's settled-read defenses, are left out on purpose
(ROADMAP.md, "Not ported, on purpose").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from vivqa_tpu_torch.models.from_jax import (flax_layouts, flax_paths,
                                            from_flax_view)
from vivqa_tpu_torch.ops.batch_mix import mix_batch, mixed_cross_entropy
from vivqa_tpu_torch.parallel.collectives import (all_gather, all_reduce,
                                                  broadcast)
from vivqa_tpu_torch.parallel.mesh import (Mesh, Sharding, batch_sharding,
                                           local_rows, logical_to_mesh,
                                           mesh_of)
from vivqa_tpu_torch.train.losses import IGNORE_INDEX, cross_entropy_loss
from vivqa_tpu_torch.train.optimizers import Optimizer
from vivqa_tpu_torch.utils.profiling import count, span
from vivqa_tpu_torch.utils.seeding import fold_in


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    seed: int
    generator: torch.Generator
    step: int = 0
    mesh: Optional[Mesh] = None         # set by place_state
    sharding: Optional[Sharding] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer,
               seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        return cls(model, optimizer, seed, torch.Generator(device=device))

    @property
    def schedule(self) -> Callable[[int], float]:
        return self.optimizer.schedule

    def step_generator(self) -> torch.Generator:
        """The generator, seeded for the current step (and this rank's
        'data' index, on a mesh with more than one)."""
        seed = fold_in(self.seed, self.step)
        if self.mesh is not None and self.mesh.data.size > 1:
            seed = fold_in(seed, self.mesh.data.rank)
        self.generator.manual_seed(seed)
        return self.generator

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer update from ``grads``: the same
        ``Optimizer.step`` that ``make_train_step`` runs (schedule,
        clipping, masks, and on a placed state the averaging over the
        mesh), then ``step`` advances. ``grads`` maps parameter names, or
        the flax paths of ``models/from_jax.flax_paths`` (a tensor in the
        flax layout), to each parameter's gradient as this rank holds
        the parameter; a parameter left out counts as a zero gradient.
        The JAX method returns a new state; this one updates the model,
        the optimizer and ``step`` in place and returns the state."""
        params = dict(self.model.named_parameters())
        by_path = layouts = None
        self.optimizer.zero_grad()
        for key, g in grads.items():
            name = key
            if key not in params:
                if by_path is None:
                    by_path = {path: n for n, path
                               in flax_paths(self.model).items()}
                    layouts = flax_layouts(self.model)
                if key not in by_path:
                    raise KeyError(f"no parameter named or at flax path "
                                   f"'{key}'")
                name = by_path[key]
                g = from_flax_view(layouts[name], g, params[name].shape)
            p = params[name]
            if tuple(g.shape) != tuple(p.shape):
                raise ValueError(f"gradient of '{key}' is "
                                 f"{tuple(g.shape)}, the parameter "
                                 f"{tuple(p.shape)}")
            p.grad = g.detach().to(device=p.device, dtype=p.dtype).clone()
        self.optimizer.step()
        self.step += 1
        return self


KNOWLEDGE_KEYS = ("knowledge_embeddings", "knowledge_mask")


def knowledge_of(batch: dict) -> dict:
    """The knowledge arrays a ``KnowledgeProvider`` attached to ``batch``
    (none when no provider wraps the loader), as the model's keyword
    arguments."""
    return {k: batch[k] for k in KNOWLEDGE_KEYS if k in batch}


def classification_loss_fn(aux_weight: float = 0.01,
                           label_smoothing: float = 0.0,
                           expert_mask: Optional[torch.Tensor] = None,
                           mix_mode: str = "none", mix_alpha: float = 0.4
                           ) -> Callable:
    """The classification loss (bench.py's, and the training pipeline's
    ``_loss_fn``): cross-entropy of the answer logits plus ``aux_weight``
    times the MoE router's aux loss. batch: dict of pixel_values,
    input_ids, attention_mask, labels on the model's device, and the
    knowledge arrays when a provider attached them. With ``mix_mode``
    (mixup | cutmix | both, ``ops/batch_mix.py``) the pixels are mixed
    first, with draws from the step's generator, and the loss and
    accuracy are the λ-weighted pair over each row's labels and its
    partner's. The metrics ``ce``, ``aux_loss`` and ``accuracy`` are 0-d
    tensors on the device."""
    def loss_fn(model: nn.Module, batch: dict, generator: torch.Generator):
        pixels, labels = batch["pixel_values"], batch["labels"]
        if mix_mode != "none":
            pixels, perm, lam = mix_batch(generator, pixels, mix_mode,
                                          mix_alpha)
        out = model(pixels, batch["input_ids"],
                    batch["attention_mask"], expert_mask=expert_mask,
                    generator=generator, **knowledge_of(batch))
        preds = out["logits"].detach().argmax(-1)
        if mix_mode != "none":
            labels_b = labels[perm]
            with span("loss"):
                ce = mixed_cross_entropy(out["logits"], labels, labels_b,
                                         lam, label_smoothing)
            accuracy = (lam * (preds == labels).float().mean()
                        + (1 - lam) * (preds == labels_b).float().mean())
        else:
            mesh = mesh_of(model)
            with span("loss"):
                ce = cross_entropy_loss(out["logits"], labels,
                                        label_smoothing,
                                        data=mesh.data if mesh else None)
            accuracy = (preds == labels).float().mean()
        return ce + aux_weight * out["aux_loss"], {
            "ce": ce.detach(), "aux_loss": out["aux_loss"].detach(),
            "accuracy": accuracy}
    return loss_fn


def generative_loss_fn(label_smoothing: float = 0.1,
                       moe_aux_weight: float = 0.01,
                       expert_mask: Optional[torch.Tensor] = None
                       ) -> Callable:
    """The generative pipeline's teacher-forcing loss
    (generative_training_pipeline.py:87-107): cross-entropy of the logits
    against ``labels`` with ``IGNORE_INDEX`` positions left out, plus
    ``moe_aux_weight`` times the MoE aux loss. batch: dict of
    pixel_values, question_ids, question_mask, decoder_input_ids,
    decoder_mask, labels on the model's device, and the knowledge arrays
    when a provider attached them. The metrics ``ce``, ``aux_loss`` and
    ``n_tokens`` (labels that count) are 0-d tensors on the device;
    under a profiler ``n_tokens`` adds to the counter
    ``decoder.labelled``."""
    def loss_fn(model: nn.Module, batch: dict, generator: torch.Generator):
        out = model(batch["pixel_values"], batch["question_ids"],
                    batch["decoder_input_ids"], batch["question_mask"],
                    batch["decoder_mask"], expert_mask=expert_mask,
                    generator=generator, **knowledge_of(batch))
        mesh = mesh_of(model)
        with span("loss"):
            ce = cross_entropy_loss(out["logits"], batch["labels"],
                                    label_smoothing,
                                    ignore_index=IGNORE_INDEX,
                                    data=mesh.data if mesh else None)
        n_tokens = (batch["labels"] != IGNORE_INDEX).sum()
        count("decoder.labelled", n_tokens)
        return ce + moe_aux_weight * out["aux_loss"], {
            "ce": ce.detach(), "aux_loss": out["aux_loss"].detach(),
            "n_tokens": n_tokens}
    return loss_fn


def make_train_step(loss_fn: Callable) -> Callable:
    """loss_fn(model, batch, generator) -> (loss, metrics dict).

    Returns train_step(state, batch) -> (state, metrics): one forward in
    train mode, backward, clip and AdamW update. ``metrics`` gains
    ``loss`` and ``grad_norm`` (the global norm before clipping), both
    0-d tensors on the device, so the step never waits for the card.
    Under a profiler the step is the span ``train_step`` around
    ``forward`` (the loss function), ``backward`` and ``optimizer``.
    """
    def train_step(state: TrainState, batch: dict):
        with span("train_step"):
            state.model.train()
            state.optimizer.zero_grad()
            with span("forward"):
                loss, metrics = loss_fn(state.model, batch,
                                        state.step_generator())
            with span("backward"):
                loss.backward()
            with span("optimizer"):
                grad_norm = state.optimizer.step()
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics
    return train_step


def make_eval_step(metric_fn: Callable) -> Callable:
    """metric_fn(model, batch) -> metrics dict, run in eval mode with no
    gradient."""
    def eval_step(state: TrainState, batch: dict):
        state.model.eval()
        with torch.no_grad():
            return metric_fn(state.model, batch)
    return eval_step


def place_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Put a freshly built (or resumed) state on the mesh: every rank
    takes global rank 0's parameters, then keeps its slice of each one
    the rules split, and of its optimizer state (copies), and the modules
    switch to their parallel forms. A state rebuilt over a model already
    placed on ``mesh`` (a trainer's new stage) keeps its slices and only
    its optimizer learns the mesh. On a 1x1 mesh the state is left as it
    is (the single-card step)."""
    if mesh.size == 1:
        return state
    if mesh_of(state.model) is mesh:
        sharding = state.model.mesh_sharding
        state.optimizer.use_mesh(mesh, sharding)
        state.mesh, state.sharding = mesh, sharding
        return state
    params = [p for p in state.model.parameters()]
    with torch.no_grad():
        for axis in (mesh.data, mesh.model):
            flat = torch.cat([p.detach().reshape(-1) for p in params])
            flat = broadcast(flat, axis)
            offset = 0
            for p in params:
                p.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
    sharding = logical_to_mesh(state.model, mesh)
    state.optimizer.use_mesh(mesh, sharding)
    state.mesh, state.sharding = mesh, sharding
    return state


def replicate_metrics(metrics: dict, mesh: Mesh,
                      rows: Optional[int] = None) -> dict:
    """A rank's metrics -> the global step's, equal on every rank: 0-d
    tensors averaged over 'data' (summed for counts, the ``n_*`` keys),
    tensors of ``rows`` leading rows (a rank's predictions) gathered in
    rank order, other tensors averaged; dicts recursively."""
    d = mesh.data
    if d.size == 1:
        return metrics
    out, scalars = {}, []
    for k, v in metrics.items():
        if isinstance(v, dict):
            out[k] = replicate_metrics(v, mesh, rows)
        elif not isinstance(v, torch.Tensor):
            out[k] = v
        elif v.dim() and rows is not None and v.shape[0] == rows:
            out[k] = all_gather(v, d)
        else:
            scalars.append(k)
    if scalars:
        flat = torch.cat([metrics[k].detach().double().reshape(-1)
                          for k in scalars])
        total = all_reduce(flat, d)
        offset = 0
        for k in scalars:
            v = metrics[k]
            n = v.numel()
            t = total[offset:offset + n].view(v.shape)
            if not k.startswith("n_"):
                t = t / d.size
            out[k] = t.to(v.dtype)
            offset += n
    return out


@dataclasses.dataclass
class ShardedStep:
    """A train (and eval) step on a mesh: each rank takes its 'data'
    rows of the global batch, the gradient averaging and the metrics'
    reduction make it the global step (counterpart of the JAX package's
    ``ShardedStep``, which compiles the step with GSPMD shardings)."""
    mesh: Mesh
    train_step: Callable
    eval_step: Optional[Callable] = None

    def compile(self, state: TrainState):
        """-> (train, eval, placements, batch placement); on one device
        the plain steps and None, None."""
        if self.mesh.size == 1:
            return self.train_step, self.eval_step, None, None
        if state.mesh is not self.mesh:
            raise ValueError("place_state(state, mesh) first")
        mesh = self.mesh

        def train(state: TrainState, batch: dict):
            state, metrics = self.train_step(state, local_rows(batch, mesh))
            return state, replicate_metrics(metrics, mesh)

        evaluate = None
        if self.eval_step is not None:
            def evaluate(state: TrainState, batch: dict):
                local = local_rows(batch, mesh)
                rows = len(next(iter(local.values())))
                return replicate_metrics(self.eval_step(state, local), mesh,
                                         rows)
        return (train, evaluate, state.sharding.placements,
                batch_sharding(mesh))
