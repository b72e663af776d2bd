"""KV-cached autoregressive decoding: greedy / top-k / top-p / beam search
(counterpart of vivqa_tpu/models/decoding.py).

The JAX package runs each decode as one device ``lax.while_loop`` (its
single-loop form works around a TPU miscompile). Here each is a Python
loop of eager steps over a ``DecodeCache``:

- ``early_exit=False`` runs all ``max_length`` steps and never waits on
  the card inside the loop;
- ``early_exit=True`` reads one flag per step (all rows done, or no live
  beam can still beat the worst finished one) and stops as soon as no
  output can change: its output is identical to the fixed loop's;
- beam search folds the beams into the batch (row b*K + k is beam k of
  row b, as ``jnp.repeat`` lays them out) and reorders the self-attention
  cache when beams are reordered; the cross-attention K/V are the same
  for every beam of a row and are left alone.

Top-k selections break ties to the lower index, as ``jax.lax.top_k``
does. Sampling draws from an explicit ``torch.Generator``; its stream is
not ``jax.random``'s, so sampled tokens agree with the JAX package in
distribution only.

All functions take ``apply_fn(cache, tokens) -> (logits, cache)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from vivqa_tpu_torch.models.decoder import DecodeCache

NEG_INF = -1.0e7


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_length: int = 64
    bos_token_id: int = 0
    eos_token_id: int = 2
    pad_token_id: int = 1
    strategy: str = "greedy"        # greedy | top_k | top_p | beam
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 0.9
    num_beams: int = 4
    length_penalty: float = 0.6     # Google-NMT alpha
    # Stop as soon as no output can change (output-identical to the
    # fixed loop; one host read per step). False = fixed work per call.
    early_exit: bool = True


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, ties to the lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def filter_logits(logits: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    """Temperature, then top-k or top-p filtering: filtered-out tokens get
    NEG_INF."""
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.strategy == "top_k":
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    elif cfg.strategy == "top_p":
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # keep tokens until the cumulative prob exceeds top_p (always the
        # first)
        cutoff_mask = torch.cumsum(probs, dim=-1) - probs > cfg.top_p
        cutoff_logit = torch.where(cutoff_mask, torch.inf,
                                   sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff_logit, NEG_INF, logits)
    return logits


def _sample_logits(logits: torch.Tensor, generator: torch.Generator,
                   cfg: DecodeConfig) -> torch.Tensor:
    """Argmax (greedy), or a draw from softmax(filter_logits(logits)) by
    the Gumbel-max trick: argmax(logits - log E), E ~ Exp(1)."""
    if cfg.strategy == "greedy":
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, cfg)
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def autoregressive_decode(apply_fn: Callable, cache: DecodeCache,
                          batch_size: int, cfg: DecodeConfig,
                          generator: Optional[torch.Generator] = None):
    """Greedy / top-k / top-p decode.

    Returns (sequences (B, max_length) int64, scores (B,) summed f32
    logprobs). Sequences start with the first generated token (BOS not
    included); positions after EOS hold pad. ``generator`` (on the
    cache's device) drives sampling; None seeds one with 0.
    """
    dev = cache.self_kv.device
    if generator is None and cfg.strategy != "greedy":
        generator = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.full((batch_size, 1), cfg.bos_token_id, dtype=torch.long,
                        device=dev)
    seqs = torch.full((batch_size, cfg.max_length), cfg.pad_token_id,
                      dtype=torch.long, device=dev)
    done = torch.zeros(batch_size, dtype=torch.bool, device=dev)
    score = torch.zeros(batch_size, dtype=torch.float32, device=dev)
    for t in range(cfg.max_length):
        logits, cache = apply_fn(cache, tokens)
        nxt = _sample_logits(logits, generator, cfg)
        tok_logp = torch.log_softmax(logits, dim=-1).gather(
            -1, nxt[:, None])[:, 0]
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        score = score + torch.where(done, 0.0, tok_logp)
        done = done | (nxt == cfg.eos_token_id)
        seqs[:, t] = nxt
        tokens = nxt[:, None]
        if cfg.early_exit and bool(done.all()):
            break
    return seqs, score


# -- beam search --------------------------------------------------------------
def _gather_beams(cache: DecodeCache, beam_idx: torch.Tensor,
                  batch_size: int, num_beams: int) -> DecodeCache:
    """Reorder the self-attention cache along the folded (batch*beam)
    axis; beam_idx (B, K) in [0, K). The cross-attention K/V, identical
    across the beams of a row, are left as they are."""
    rows = torch.arange(batch_size, device=beam_idx.device)[:, None]
    flat = (rows * num_beams + beam_idx).reshape(-1)
    return dataclasses.replace(cache,
                               self_kv=cache.self_kv.index_select(2, flat))


def _length_penalty(length, alpha: float):
    return ((5.0 + length) / 6.0) ** alpha


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx[..., None], axis=1)`` for x (B, N, L)
    and idx (B, M)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def beam_search(apply_fn: Callable, cache: DecodeCache, batch_size: int,
                cfg: DecodeConfig):
    """Batched beam search with KV-cache reordering.

    ``cache`` must already be tiled to batch*num_beams (``tile_for_beams``
    on the memory before the cache is made). Returns (sequences
    (B, max_length), scores (B,)) of the best finished beam (or of the
    best live beam if none finished).
    """
    K, L, B = cfg.num_beams, cfg.max_length, batch_size
    dev = cache.self_kv.device
    live_scores = torch.full((B, K), NEG_INF, device=dev)
    live_scores[:, 0] = 0.0
    live_seqs = torch.full((B, K, L), cfg.pad_token_id, dtype=torch.long,
                           device=dev)
    fin_scores = torch.full((B, K), NEG_INF, device=dev)
    fin_seqs = live_seqs.clone()
    tokens = torch.full((B * K, 1), cfg.bos_token_id, dtype=torch.long,
                        device=dev)
    # Early exit (t5x-style bound): raw log-prob scores only fall as beams
    # extend, and the penalty is largest at length L for alpha >= 0 (at
    # length 1, where it is 1, for alpha < 0), so live_score / pen_max is
    # the best penalized score a live beam can still reach. Once in every
    # row it cannot beat the row's K-th finished score, no later step can
    # change the output.
    pen_max = max(_length_penalty(L, cfg.length_penalty), 1.0)
    for t in range(L):
        if cfg.early_exit and not bool(
                (live_scores[:, 0] / pen_max > fin_scores[:, -1]).any()):
            break
        logits, cache = apply_fn(cache, tokens)                # (BK, V)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits, dim=-1).view(B, K, V)
        cand = live_scores[..., None] + logp                   # (B, K, V)
        # Two stages: the global top 2K lies within each beam's own top
        # 2K, so reduce each beam over the vocab first, then the K*2K.
        s1_scores, s1_tok = top_k(cand.view(B * K, V), 2 * K)
        top_scores, flat_idx = top_k(s1_scores.reshape(B, 2 * K * K), 2 * K)
        top_beam = flat_idx // (2 * K)
        top_tok = torch.gather(s1_tok.reshape(B, 2 * K * K), 1, flat_idx)

        cand_seqs = _take(live_seqs, top_beam)                 # (B, 2K, L)
        cand_seqs[:, :, t] = top_tok
        is_eos = top_tok == cfg.eos_token_id

        # finished pool: EOS candidates with the length penalty
        pen = _length_penalty(t + 1, cfg.length_penalty)
        cand_fin = torch.where(is_eos, top_scores / pen, NEG_INF)
        fin_scores, fin_idx = top_k(torch.cat([fin_scores, cand_fin], 1), K)
        fin_seqs = _take(torch.cat([fin_seqs, cand_seqs], 1), fin_idx)

        # live beams: the best K non-EOS candidates
        live_scores, live_idx = top_k(
            torch.where(is_eos, NEG_INF, top_scores), K)
        live_seqs = _take(cand_seqs, live_idx)
        tokens = torch.gather(top_tok, 1, live_idx).view(B * K, 1)
        cache = _gather_beams(cache, torch.gather(top_beam, 1, live_idx),
                              B, K)

    none_finished = (fin_scores <= NEG_INF / 2).all(dim=1)
    live_pen = live_scores / _length_penalty(L, cfg.length_penalty)
    best_fin = torch.argmax(fin_scores, dim=1, keepdim=True)
    best_live = torch.argmax(live_pen, dim=1, keepdim=True)
    seqs = torch.where(none_finished[:, None],
                       _take(live_seqs, best_live)[:, 0],
                       _take(fin_seqs, best_fin)[:, 0])
    scores = torch.where(none_finished,
                         torch.gather(live_pen, 1, best_live)[:, 0],
                         torch.gather(fin_scores, 1, best_fin)[:, 0])
    return seqs, scores


def tile_for_beams(tensor: torch.Tensor, num_beams: int) -> torch.Tensor:
    """(B, ...) -> (B*K, ...), each row repeated K times in place
    (``jnp.repeat``: rows b*K ... b*K + K - 1 are copies of row b)."""
    B, *rest = tensor.shape
    return tensor[:, None].expand(B, num_beams, *rest).reshape(
        B * num_beams, *rest)


# -- model-level generate ----------------------------------------------------
def build_generate_fn(model, cfg: DecodeConfig) -> Callable:
    """generate(pixel_values, question_ids, question_mask=None,
    generator=None, expert_mask=None, knowledge_embeddings=None,
    knowledge_mask=None) -> (sequences, scores) for a
    ``GenerativeVQAModel``, on the device of its inputs, with no
    gradient.

    ``expert_mask`` reaches the fusion MoE, so a model trained with an
    ablation mask decodes with the same experts. The knowledge arrays
    (a ``KnowledgeProvider``'s) join the memory as ``encode`` takes them;
    beam search tiles the whole memory, knowledge tokens included."""

    def generate(pixel_values, question_ids, question_mask=None,
                 generator=None, expert_mask=None, knowledge_embeddings=None,
                 knowledge_mask=None):
        with torch.inference_mode():
            enc = model.encode(pixel_values, question_ids, question_mask,
                               expert_mask,
                               knowledge_embeddings=knowledge_embeddings,
                               knowledge_mask=knowledge_mask)
            memory, memory_mask = enc["memory"], enc["memory_mask"]
            B = memory.shape[0]
            if cfg.strategy == "beam":
                memory = tile_for_beams(memory, cfg.num_beams)
                memory_mask = tile_for_beams(memory_mask, cfg.num_beams)
            cache = model.init_cache(memory, memory_mask, cfg.max_length)
            if cfg.strategy == "beam":
                return beam_search(apply_fn, cache, B, cfg)
            return autoregressive_decode(apply_fn, cache, B, cfg, generator)

    def apply_fn(cache, tokens):
        return model.decode_step(tokens, cache)

    return generate
