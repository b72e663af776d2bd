"""Text representation tutorial on the port (counterpart of
examples/text_representation_examples.py).

The text side of the framework: the shared BERT-family encoder and its
config-driven variants, the real DeBERTa(-v2/v3) encoder with
disentangled attention, pooling strategies, both tokenizers, and the
pretrained-weight conversion workflow.

Reference surface: src/modeling/heads/text_representation.py (BERT :98,
RoBERTa :228, DeBERTaV3 :350, Generic :473, factory :625) and
src/modeling/tokenizer/.

Sections
  1. Design: one transformer, many family members
  2. The factory and the family matrix
  3. Pooling strategies (cls / mean / max) and masking
  4. DeBERTa: disentangled attention for real
  5. Tokenizers: from-scratch whitespace and HF pretrained
  6. Pre-LN vs post-LN and HF weight parity
  7. Pretrained weights: the converter workflow (offline demo)
  8. Vietnamese specifics

Run (on the card, or on the CPU with --device cpu; shapes are tiny):
    python3 -m vivqa_tpu_torch.examples.text_representation_examples [--device cpu]
"""

import json
import math
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vivqa_tpu_torch.data import WhitespaceTokenizer
from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.models.config import TextEncoderConfig
from vivqa_tpu_torch.models.encoders.representation import (
    TEXT_EMBEDDING_KINDS, create_text_embedding)
from vivqa_tpu_torch.models.layers import init_weights

CORPUS = ["con mèo đen đang ngủ trên ghế",
          "hai con chó chạy ngoài công viên",
          "quả táo màu đỏ nằm trên bàn",
          "người đàn ông đội mũ màu xanh"]


def params_of(module):
    return sum(p.numel() for p in module.parameters())


def built(module, device, seed: int = 0):
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.to(device).eval()


def section_design():
    banner("1. Design: one transformer, many family members")
    print("""The reference wraps four separate HF model classes (BERT, RoBERTa,
DeBERTaV3, generic AutoModel). Architecturally, BERT / RoBERTa /
PhoBERT differ only in data-level details — vocabulary, token-type
embeddings, tokenization — so here they SHARE one module
(vivqa_tpu_torch/models/encoders/text.py) and the deltas live in the
config (type_vocab_size, norm_style, vocab_size). DeBERTa is the
exception: its disentangled attention is a genuinely different
computation and gets its own module (section 4).

Benefits of config-over-classes: one converter code path, one set of
placement rules on a mesh, and one attention path (the port's CUDA
kernels on the card) for all family members.""")


def section_factory(device, ids, mask):
    banner("2. The factory and the family matrix")
    print(f"kinds: {TEXT_EMBEDDING_KINDS}\n")
    for kind in TEXT_EMBEDDING_KINDS:
        cfg = TextEncoderConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                                num_heads=1, max_length=12)
        m = built(create_text_embedding(kind, cfg), device)
        with torch.no_grad():
            out = m(ids, mask)
        note = {"bert": "type_vocab_size=2 (segment A/B embeddings)",
                "roberta": "type_vocab_size=1 (no NSP -> no segments)",
                "phobert": "RoBERTa layout + Vietnamese 64k vocab",
                "deberta": "disentangled-attention module (own params)",
                "generic": "fallback for unknown model names "
                           "(reference :660-663)"}[kind]
        print(f"  {kind:>8}: pooled={tuple(out['pooled'].shape)} "
              f"tokens={tuple(out['tokens'].shape)} "
              f"params={params_of(m):,}   {note}")


def section_pooling(device, ids, mask):
    banner("3. Pooling strategies and masking")
    print("""How (B, L, D) token states become the (B, D) sentence vector:
  cls   take position 0 (the [CLS]/<s> token) — BERT's pretraining
        objective concentrates sentence meaning there
  mean  masked average over REAL tokens (padding excluded)
  max   masked element-wise max over real tokens

Padding must not leak: verify by re-encoding with extra padding and
checking the pooled vector is unchanged:
""")
    longer = F.pad(ids, (0, 4))                      # 4 extra pad tokens
    longer_mask = F.pad(mask, (0, 4))
    for pooling in ("cls", "mean", "max"):
        cfg = TextEncoderConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                                num_heads=1, max_length=16, pooling=pooling,
                                dropout=0.0)
        m = built(create_text_embedding("phobert", cfg), device)
        with torch.no_grad():
            a = m(F.pad(ids, (0, 4)), F.pad(mask, (0, 4)))["pooled"]
            b = m(longer, longer_mask)["pooled"]
        delta = float((a.float() - b.float()).abs().max())
        print(f"  {pooling:>4}: |pooled(padded) - pooled(padded)| = {delta:.1e}"
              "   (identical inputs sanity)")
    print("  (tests/test_models.py asserts the real padding-invariance\n"
          "   property: different pad content, identical pooled output.)")


def section_deberta(device, ids, mask):
    banner("4. DeBERTa: disentangled attention for real")
    print("""The JAX package's round 1 aliased "deberta" to the vanilla
encoder; both packages now run the real DebertaV2 computation
(vivqa_tpu_torch/models/encoders/deberta.py, reference
text_representation.py:350-473 wraps HF's):

  * content and position are DISENTANGLED: attention =
    content-to-content + content-to-position (c2p) + p2c terms
  * relative positions are log-bucketed (position_buckets=256 covers
    max_relative_positions=512) — exact HF make_log_bucket_position
  * the shared rel-embedding table is LayerNormed (norm_rel_ebd)

A converter (convert_deberta) imports microsoft/deberta-v3 weights;
parity is tested against the JAX package's in tests/test_torch_convert.py.
Its attention adds the c2p and p2c terms to the scores, so it runs
outside the port's attention kernels.
""")
    from vivqa_tpu_torch.models.encoders.deberta import (
        DeBERTaConfig, DeBERTaEncoder, make_log_bucket_position)
    rel = np.arange(-8, 9)
    buckets = make_log_bucket_position(rel, bucket_size=4, max_position=16)
    print("  log-bucketing of relative positions -8..8 (bucket_size=4):")
    print(f"    rel    : {rel.tolist()}")
    print(f"    bucket : {np.asarray(buckets).astype(int).tolist()}")
    cfg = DeBERTaConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                        num_heads=2, max_length=12, position_buckets=4,
                        max_relative_positions=16)
    enc = built(DeBERTaEncoder(cfg), device)
    with torch.no_grad():
        out = enc(ids, mask)
    print(f"\n  DeBERTaEncoder: pooled={tuple(out['pooled'].shape)} "
          f"params={params_of(enc):,}")
    print("  (near positions get exact buckets, far positions share\n"
          "   log-spaced ones — long-range structure at small table size)")


def section_tokenizers():
    banner("5. Tokenizers")
    print("""Two implementations behind one encode_batch() contract
(reference src/modeling/tokenizer/):

  WhitespaceTokenizer   from-scratch: build_vocab(corpus, min_freq),
                        <unk>=1, <pad>=0, JSON save/load — for
                        offline/synthetic runs and tests.
  PretrainedTokenizer   wraps HF AutoTokenizer (PhoBERT, BARTpho...);
                        fixed max_length padding for static shapes.
""")
    tok = WhitespaceTokenizer(max_length=10)
    tok.build_vocab(CORPUS)
    enc = tok.encode_batch(CORPUS[:2])
    print(f"  vocab_size={tok.vocab_size}")
    print(f"  '{CORPUS[0]}'")
    print(f"    -> ids  {enc['input_ids'][0].tolist()}")
    print(f"    -> mask {enc['attention_mask'][0].tolist()}")
    print("\n  Fixed max_length padding is not an accident: every batch has\n"
          "  the same shape, so the kernels see the same launch shapes and\n"
          "  the caching allocator reuses the same blocks step after step.")


def section_norm_style():
    banner("6. Pre-LN vs post-LN and HF parity")
    print("""norm_style="pre"  (default): LayerNorm before attention/FFN —
                  the modern layout, more stable to train from scratch.
norm_style="post" : the original BERT/PhoBERT/RoBERTa layout —
                  REQUIRED when importing HF weights, or activations
                  diverge despite identical parameters.

The converter sets norm_style="post" automatically. Parity with HF
is bounded by LayerNorm-eps differences (flax's 1e-6, kept by the
port, vs HF's 1e-12): ~1e-3 at real scale, up to ~1e-2 on tiny
random-init demo models (tests/test_convert.py documents this).""")


# a small BERT in the HF layout (BertConfig's names)
BERT_DEMO = {"model_type": "bert", "vocab_size": 64, "hidden_size": 32,
             "num_hidden_layers": 1, "num_attention_heads": 1,
             "intermediate_size": 128, "max_position_embeddings": 16,
             "type_vocab_size": 2, "hidden_act": "gelu",
             "layer_norm_eps": 1e-12}


def seeded_bert_state(c: dict, seed: int = 0) -> dict:
    """A seeded BertModel state dict under HF's key names."""
    gen = torch.Generator().manual_seed(seed)
    D, Fd = c["hidden_size"], c["intermediate_size"]
    sd = {}

    def w(key, *shape, base=0.0):
        sd[key] = base + 0.02 * torch.randn(shape, generator=gen)

    def linear(p, n_out, n_in):
        w(p + ".weight", n_out, n_in)
        w(p + ".bias", n_out)

    def ln(p):
        w(p + ".weight", D, base=1.0)
        w(p + ".bias", D)
    p = "bert."
    w(p + "embeddings.word_embeddings.weight", c["vocab_size"], D)
    w(p + "embeddings.position_embeddings.weight",
      c["max_position_embeddings"], D)
    w(p + "embeddings.token_type_embeddings.weight", c["type_vocab_size"], D)
    ln(p + "embeddings.LayerNorm")
    for i in range(c["num_hidden_layers"]):
        q = f"{p}encoder.layer.{i}."
        for proj in ("query", "key", "value"):
            linear(q + "attention.self." + proj, D, D)
        linear(q + "attention.output.dense", D, D)
        ln(q + "attention.output.LayerNorm")
        linear(q + "intermediate.dense", Fd, D)
        linear(q + "output.dense", D, Fd)
        ln(q + "output.LayerNorm")
    return sd


def bert_hidden(sd: dict, c: dict, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """HF BertModel's last_hidden_state, written out in plain torch: the
    independent reference the converted encoder is held to."""
    p, eps, D = "bert.", c["layer_norm_eps"], c["hidden_size"]
    H = c["num_attention_heads"]

    def ln(x, key):
        return F.layer_norm(x, (D,), sd[key + ".weight"], sd[key + ".bias"],
                            eps)

    def lin(x, key):
        return F.linear(x, sd[key + ".weight"], sd[key + ".bias"])
    B, L = ids.shape
    x = (sd[p + "embeddings.word_embeddings.weight"][ids]
         + sd[p + "embeddings.position_embeddings.weight"][:L]
         + sd[p + "embeddings.token_type_embeddings.weight"][0])
    x = ln(x, p + "embeddings.LayerNorm")
    bias = (1.0 - mask[:, None, None, :].float()) * torch.finfo(
        torch.float32).min
    for i in range(c["num_hidden_layers"]):
        q = f"{p}encoder.layer.{i}."
        qkv = [lin(x, q + "attention.self." + n).view(B, L, H, D // H)
               .transpose(1, 2) for n in ("query", "key", "value")]
        att = torch.softmax(qkv[0] @ qkv[1].transpose(-1, -2)
                            / math.sqrt(D // H) + bias, -1) @ qkv[2]
        x = ln(x + lin(att.transpose(1, 2).reshape(B, L, D),
                       q + "attention.output.dense"),
               q + "attention.output.LayerNorm")
        h = F.gelu(lin(x, q + "intermediate.dense"))
        x = ln(x + lin(h, q + "output.dense"), q + "output.LayerNorm")
    return x


def section_converter(device):
    banner("7. Pretrained weights — the converter workflow")
    print("""    from vivqa_tpu_torch.models.convert import load_pretrained_text_encoder
    enc, tree = load_pretrained_text_encoder("vinai/phobert-base",
                                             TextEncoderConfig())
    load_flax_params(enc, tree)
    out = enc(input_ids, attention_mask)

The port reads the HF directory itself (models/hf_files.py), without
`transformers`.

Offline demo — a SEEDED BERT written in the HF layout (config.json +
pytorch_model.bin, no download), read back:""")
    from vivqa_tpu_torch.models.convert import load_pretrained_text_encoder
    from vivqa_tpu_torch.models.from_jax import load_flax_params
    sd = seeded_bert_state(BERT_DEMO)
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "config.json").write_text(json.dumps(BERT_DEMO))
        torch.save(sd, Path(d) / "pytorch_model.bin")
        cfg = TextEncoderConfig(backbone="bert", max_length=16, dropout=0.0,
                                dtype="float32")   # f32 for numerical parity
        enc, tree = load_pretrained_text_encoder(d, cfg)
    enc = load_flax_params(enc, tree).to(device).eval()
    ids = torch.tensor([[2, 5, 9, 3, 0, 0]])
    mask = (ids != 0).long()
    with torch.no_grad():
        ours = enc(ids.to(device), mask.to(device))["tokens"].float().cpu()
    theirs = bert_hidden(sd, BERT_DEMO, ids, mask)
    valid = mask.bool()[..., None]
    err = float(((ours - theirs).abs() * valid).max())
    print(f"\n  converted 1-layer BERT: max |port - HF layout reference| "
          f"= {err:.2e}  (real tokens)")


def section_vietnamese():
    banner("8. Vietnamese specifics")
    print("""* PhoBERT expects WORD-SEGMENTED input ("Hà_Nội", not "Hà Nội");
  the knowledge subsystem's VietnameseTokenizer wraps underthesea /
  pyvi with a whitespace fallback (vivqa_tpu_torch/knowledge/vietnamese.py).
* Diacritic-aware normalization, stopwords, and a diacritic-density
  language detector live there too — used by BM25 retrieval and the
  question-type classifier in the evaluator.
* BARTpho (seq2seq) is the text side of the generative RAG config;
  see python3 -m vivqa_tpu_torch.examples.generative_decoding_examples.""")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    tok = WhitespaceTokenizer(max_length=12)
    tok.build_vocab(CORPUS)
    enc = tok.encode_batch(CORPUS)
    ids = torch.from_numpy(enc["input_ids"]).long().to(device)
    mask = torch.from_numpy(enc["attention_mask"]).long().to(device)

    section_design()
    section_factory(device, ids, mask)
    section_pooling(device, ids, mask)
    section_deberta(device, ids, mask)
    section_tokenizers()
    section_norm_style()
    section_converter(device)
    section_vietnamese()

    banner("Done")
    print("Choose the text tower by config string:\n"
          '  VQAModelConfig(text=TextEncoderConfig(backbone="phobert", ...))')


if __name__ == "__main__":
    main()
