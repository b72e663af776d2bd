"""Plain reference of a training step: the loss over the whole batch, its
gradient, global-norm clipping and AdamW (optax's formulas) under a
warmup-cosine schedule, in float32.

A batch too large for one pass beside its activations is computed in
blocks of rows, with the exact gradient of the whole batch's loss:

- the loss is the sum of the blocks' loss sums over the whole batch's
  count of positions (rows, or labels that count);
- each MoE router's load-balance loss couples the rows, through the
  share of the batch's tokens that kept each expert. A first pass
  without gradients takes those shares over the whole batch; in the
  second each block's gradient is that of its own part of
  ``E * sum_e(share_e * mean_prob_e)`` at those shares;
- the dropout masks are drawn once at the whole batch's shapes and each
  block takes its rows (``layers.Dropout``).
"""

from __future__ import annotations

import math
import re

import torch

from benchmark.reference.layers import Dropout, fold_in

# parameters that take no weight decay: biases, LayerNorms, embeddings,
# the class token
_NO_DECAY = (r"(^|\.)bias$", r"(^|\.)ln[0-9_a-z]*\.",
             r"(^|\.)(token|pos|type)_embed(\.|$)", r"cls_token",
             r"experts_bias_")


def decays(name: str) -> bool:
    return not any(re.search(p, name) for p in _NO_DECAY)


def warmup_cosine(count: int, base_lr: float, warmup: int,
                  total: int) -> float:
    """Linear from 0 to ``base_lr`` over ``warmup`` updates, then a cosine
    to 0 at ``total``."""
    if count < warmup:
        return base_lr * count / warmup
    steps = total - warmup
    return base_lr * 0.5 * (1 + math.cos(math.pi * min(count - warmup,
                                                       steps) / steps))


class AdamW:
    def __init__(self, named_params: list, opt: dict):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.opt = opt
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """Clip ``grads`` to the global norm, update; returns the clipped
        gradients."""
        o = self.opt
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = 1.0 if norm < o["grad_clip_norm"] \
            else o["grad_clip_norm"] / float(norm)
        grads = [g * scale for g in grads]
        b1, b2, t = o["beta1"], o["beta2"], self.count + 1
        lr = warmup_cosine(self.count, o["learning_rate"], o["warmup_steps"],
                           o["total_steps"])
        for name, p, g, m, v in zip(self.names, self.params, grads, self.mu,
                                    self.nu):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t))
                                        + o["eps"])
            if decays(name):
                u = u + o["weight_decay"] * p
            p.add_(u, alpha=-lr)
        self.count += 1
        return grads


def batch_rows(batch: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in batch.items()}


def loss_and_grads(model, batch: dict, generator: torch.Generator,
                   loss: dict, block: int):
    """The step's loss (a float) and each parameter's gradient (a list in
    ``model.named_parameters()`` order), over the whole batch in blocks
    of ``block`` rows. ``loss``: ``label_smoothing``, ``aux_weight`` and
    the routers' ``load_balance_weight``."""
    B = next(iter(batch.values())).shape[0]
    blocks = [slice(i, min(i + block, B)) for i in range(0, B, block)]
    drop = Dropout(generator, B)
    count = model.loss_count(batch)
    ls = loss["label_smoothing"]
    aux = loss["aux_weight"] * loss.get("load_balance_weight", 0.0)
    # each router's tokens that kept each expert, over the whole batch
    kept, tokens = [], []
    if model.routers:
        with torch.no_grad():
            for rows in blocks:
                drop.start(rows)
                _, stats = model.loss_sum(batch_rows(batch, rows), drop,
                                          label_smoothing=ls)
                if not kept:
                    kept = [torch.zeros_like(s[1]) for s in stats]
                    tokens = [0] * len(stats)
                for i, (_, assigned, n) in enumerate(stats):
                    kept[i] += assigned
                    tokens[i] += n
    params = [p for _, p in model.named_parameters()]
    grads = [torch.zeros_like(p) for p in params]
    total = 0.0
    for rows in blocks:
        drop.start(rows)
        ce, stats = model.loss_sum(batch_rows(batch, rows), drop,
                                   label_smoothing=ls)
        part = ce / count
        for (probs, _, _), k, T in zip(stats, kept, tokens):
            # E * sum_e(share_e * mean_prob_e): share_e = k_e / T, and
            # this block's part of mean_prob_e is its probabilities' sum
            # over T
            part = part + aux * probs.shape[0] * (k * probs).sum() / (T * T)
        for g, d in zip(grads, torch.autograd.grad(part, params,
                                                   allow_unused=True)):
            if d is not None:
                g.add_(d)
        total += float(part.detach())
    return total, grads


def leaf_norms(tensors) -> list:
    """Each tensor's 2-norm, summed in float64, as floats."""
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def train_steps(model, batches: list, seed: int, loss: dict, opt: dict,
                block: int) -> dict:
    """One step on each of ``batches``; the dropout of step n from a
    generator on the batches' device seeded ``fold_in(seed, n)``.
    Returns each step's loss and, by parameter name, the norm of its
    clipped first gradient and of its change over the steps."""
    named = list(model.named_parameters())
    start = [p.detach().clone() for _, p in named]
    adamw = AdamW(named, opt)
    device = next(iter(batches[0].values())).device
    gen = torch.Generator(device=device)
    losses, first = [], None
    for n, batch in enumerate(batches):
        gen.manual_seed(fold_in(seed, n))
        value, grads = loss_and_grads(model, batch, gen, loss, block)
        clipped = adamw.step(grads)
        del grads
        losses.append(value)
        if first is None:
            first = dict(zip(adamw.names, leaf_norms(clipped)))
        del clipped
    change = dict(zip(adamw.names, leaf_norms(
        p.detach() - s for (_, p), s in zip(named, start))))
    return {"losses": losses, "first_grad": first, "change": change}
