"""Generative VQA + decoding tutorial on the port (counterpart of
examples/generative_decoding_examples.py; reference:
examples/vivqa_examples.py + the generate() path of
src/modeling/meta_arch/generative_vqa_model.py:599-703).

The reference's generate() re-runs the FULL decoder stack on the
growing sequence every step (no KV cache) and accepts `num_beams`
without implementing beam search. This framework fixes both: a
KV-cached decode loop and a real batched beam search with cache
reordering and Google-NMT length penalty (t5x-style). On the card every
attention call of a step goes through the port's forward kernel.

Sections
  1. The generative model: encoder -> fusion -> decoder
  2. Teacher forcing: how training batches are built
  3. KV cache mechanics: why decode is O(L), not O(L^2)
  4. The four decoding strategies
  5. Beam search internals: scores, length penalty, cache reorder
  6. EOS handling and padding in a fixed-length loop
  7. Options: MoE in the decoder, knowledge memory (generative RAG)

Run (on the card, or on the CPU with --device cpu; shapes are tiny):
    python3 -m vivqa_tpu_torch.examples.generative_decoding_examples [--device cpu]
"""

import torch

from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.models.config import (GenerativeVQAConfig,
                                           MoEModelConfig, TextEncoderConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.models.generative import create_generative_vqa_model

VOCAB = 50
BOS, PAD, EOS = 0, 1, 49


def tiny_config(**kw):
    base = dict(
        visual=VisualEncoderConfig(image_size=32, patch_size=8,
                                   hidden_dim=32, num_layers=1, num_heads=1),
        text=TextEncoderConfig(vocab_size=VOCAB, hidden_dim=32, num_layers=1,
                               num_heads=1, max_length=8),
        fusion_dim=32, fusion_layers=1, fusion_heads=1, vocab_size=VOCAB,
        decoder_layers=2, decoder_heads=1, decoder_dim=32,
        decoder_ff_dim=64, max_answer_length=8, dropout=0.0,
        bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD)
    base.update(kw)
    return GenerativeVQAConfig(**base)


def section_model(model, px, q):
    banner("1. The generative model")
    print("""GenerativeVQAModel (reference generative_vqa_model.py:479-703):

  visual encoder (CLIP-ViT class)  -> (B, Lv, D) patch tokens
  question encoder (PhoBERT class) -> (B, Lq, D) word tokens
  CrossModalFusion: concat token streams -> transformer -> optional
    MoE -> LayerNorm -> the MEMORY the decoder cross-attends over
  TransformerDecoder: causal self-attn + cross-attn + tied output
    projection (input embedding matrix reused as the LM head)
""")
    with torch.no_grad():
        out = model(px, q, torch.full((2, 4), BOS, device=px.device))
    print(f"  teacher-forcing logits: {tuple(out['logits'].shape)}  "
          "(B, L_dec, vocab)")
    n = sum(p.numel() for p in model.parameters())
    print(f"  tiny demo model: {n:,} params")


def section_teacher_forcing():
    banner("2. Teacher forcing")
    print("""Training batches follow the reference's construction exactly
(generative_dataset.py:243-305) — these quirks define metric parity:

  answer tokens:       [tok1 tok2 tok3]
  decoder_input_ids =  [BOS  tok1 tok2 tok3]
  labels            =  [tok1 tok2 tok3 EOS]
  label padding     =  -100  (ignored by the CE loss; token-count
                              normalization uses only real tokens)

The loss also adds label smoothing and the MoE aux loss when MoE is
enabled. Perplexity is exp(min(loss, 100)) — the reference's clamp,
kept for comparability.""")


def section_kv_cache(model, px, q):
    banner("3. KV cache mechanics")
    print("""Without a cache, step t re-encodes t tokens: total O(L^2) decoder
work per sequence (this is what the reference ships). With a cache,
each layer stores its past keys/values; step t computes attention
for ONE query against cached keys — O(L) total.

The cache (models/decoder.py:DecodeCache) holds fixed-size buffers:
every self-attention layer's K and V, (layers, 2, B, L_max, H, Dh),
and the cross-attention's K/V projected once from the memory; step t
writes slice t. Cached-vs-full-stack parity is asserted in
tests/test_torch_decoding.py.
""")
    with torch.no_grad():
        enc = model.encode(px, q)
        cache = model.init_cache(enc["memory"], enc["memory_mask"], 8)
    print(f"  memory: {tuple(enc['memory'].shape)}  "
          f"cache: self {tuple(cache.self_kv.shape)}, "
          f"cross {tuple(cache.cross_kv.shape)}")
    print("  Decode work per answer token is one step of eager calls;\n"
          "  the step's position is a host integer, so no step waits on\n"
          "  the card to read it.")


def section_strategies(model, px, q):
    banner("4. The four decoding strategies")
    print("""  greedy  argmax each step — deterministic, fastest
  top_k   sample from the k most likely tokens (temperature applies)
  top_p   nucleus sampling: smallest set with cumulative prob >= p
  beam    keep num_beams hypotheses, return the best by
          length-penalized log-prob — the quality choice for VQA
""")
    for strategy in ("greedy", "top_k", "top_p", "beam"):
        dc = DecodeConfig(max_length=8, strategy=strategy, num_beams=3,
                          bos_token_id=BOS, eos_token_id=EOS,
                          pad_token_id=PAD)
        gen = build_generate_fn(model, dc)
        seqs, scores = gen(px, q, generator=torch.Generator(
            device=px.device).manual_seed(7))
        print(f"  {strategy:>7}: seq[0]={seqs[0].tolist()} "
              f"score={float(scores[0]):.2f}")
    print("\n  (random-init model -> the tokens are noise; the point is the\n"
          "   API: one generate function per strategy, any batch shape)")


def section_beam_internals():
    banner("5. Beam search internals")
    print("""The folded-beam design (t5x-style, models/decoding.py:beam_search):

  * beams ride the batch axis: (B, num_beams, ...) flattened to
    (B*num_beams, ...) so the decoder kernel is identical to greedy
  * each step: log-softmax -> add to running scores -> top-2k over
    (beam x vocab) -> REORDER THE KV CACHE by gathering the parent
    beam of each survivor (_gather_beams) — forgetting this corrupts
    every continuation silently
  * finished hypotheses are frozen (EOS -> only PAD can follow) and
    scored with the Google-NMT length penalty
    ((5+len)/6)^alpha, alpha=length_penalty=0.6
  * the loop runs at most max_length steps; early_exit=True stops it
    when no live beam can still improve the finished pool (see
    section 6)

Under tensor parallelism the gather runs on the split cache buffers;
tests/test_torch_parallel.py holds the mesh's decode against one
process.""")


def section_eos():
    banner("6. EOS handling + early exit in a device loop")
    print("""Sequences that finish keep their shape: a finished mask forces
their next token to PAD and freezes their score, so the returned
(B, L_max) tensor is exactly what the batched metrics expect: real
tokens, one EOS, PAD tail. Per-sequence EOS in a BATCH is the part the
reference never solved (it generated sample-by-sample); here it is a
vectorized mask.

And the loop itself stops early: with early_exit=True (the default)
the loop reads one flag from the card a step and stops when no output
can still change — all rows EOS'd (greedy/sampling), or no live beam's
best ACHIEVABLE length-penalized score can beat the worst finished beam
(beam search). Real VQA answers are 1-5 tokens against max_length 32,
so serving decode runs far fewer steps, with identical outputs
(tests/test_torch_decoding.py). Benchmarks pass early_exit=False to
keep fixed work per call.""")


def section_options(device):
    banner("7. Options: decoder MoE and knowledge memory")
    print("""* moe_position='decoder' (declared-but-unimplemented upstream):
    MoEModelConfig(use_moe=True, moe_position="decoder") swaps the
    decoder FFNs for MoE layers — aux losses flow into the train loss.
* Generative RAG (north-star config 5): KnowledgeModelConfig(
    use_knowledge=True) appends retrieved-context embeddings as extra
    MEMORY tokens (fusion-in-decoder style); the decoder cross-attends
    over [fused tokens; knowledge tokens] with a combined mask.
    The KnowledgeProvider stage supplies the tensors (see
    python3 -m vivqa_tpu_torch.examples.knowledge_base_examples,
    section 6).
""")
    cfg = tiny_config(moe=MoEModelConfig(use_moe=True, num_experts=2,
                                         top_k=1, expert_hidden_dim=32,
                                         moe_position="decoder"))
    model = create_generative_vqa_model(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    px = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(5)
                     ).to(device)
    q = torch.ones(2, 8, dtype=torch.int64, device=device)
    model.train()       # the router's noise and the aux loss of training
    with torch.no_grad():
        out = model(px, q, torch.full((2, 4), BOS, device=device),
                    generator=torch.Generator(device=device).manual_seed(2))
    print(f"  decoder-MoE forward OK: logits {tuple(out['logits'].shape)}, "
          f"aux_loss={float(out['aux_loss']):.4f}")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    cfg = tiny_config()
    model = create_generative_vqa_model(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    px = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(5)
                     ).to(device)
    q = torch.ones(2, 8, dtype=torch.int64, device=device)

    section_model(model, px, q)
    section_teacher_forcing()
    section_kv_cache(model, px, q)
    section_strategies(model, px, q)
    section_beam_internals()
    section_eos()
    section_options(device)
    banner("Done")
    print("Serve this model: python3 -m vivqa_tpu_torch.bench_serving\n"
          "measures answers/sec and p50/p95 latency; the demo REPL lives in\n"
          "the generative pipeline (--mode demo).")


if __name__ == "__main__":
    main()
