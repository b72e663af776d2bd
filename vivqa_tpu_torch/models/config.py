"""Model configuration dataclasses (copy of vivqa_tpu/models/config.py).

Counterpart of the reference's config surface (reference:
src/modeling/meta_arch/vqa_config.py:11-232 and
generative_vqa_model.py:27-104), redesigned as frozen, hashable
dataclasses so they can parameterize jitted functions without retriggering
traces. Backbone/fusion choices are plain strings validated by factories.

Notable differences from the reference:
- MCAN and MuTAN are *implemented* fusion types here (the reference only
  declares them as enum strings, vqa_config.py:35-36).
- Encoder configs describe the architecture structurally (layers/width/...)
  instead of naming HF hub checkpoints; HF weight import is a separate,
  optional conversion step (zero-egress environments still work).
"""

from __future__ import annotations

import dataclasses

from vivqa_tpu_torch.config.base import ConfigBase

# Valid choices (reference enums: BackboneType vqa_config.py:11-18,
# TextEncoderType :20-27, FusionType :29-37)
VISUAL_BACKBONES = ("vit", "clip", "dino", "resnet", "swin")
TEXT_BACKBONES = ("phobert", "bert", "roberta", "bartpho", "clip_text")
FUSION_TYPES = ("concat", "add", "bilinear", "cross_attention", "mcan",
                "mutan", "qformer", "single_stream")
POOLING_TYPES = ("cls", "mean", "max")


@dataclasses.dataclass(frozen=True)
class VisualEncoderConfig(ConfigBase):
    backbone: str = "clip"          # one of VISUAL_BACKBONES
    image_size: int = 224
    patch_size: int = 32            # ViT-family
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    # ResNet family
    resnet_stages: tuple = (3, 4, 6, 3)
    resnet_width: int = 64
    # "group" (from-scratch) | "frozen_bn" (pretrained-BN weights folded
    # to per-channel affine — required for convert_resnet imports)
    resnet_norm: str = "group"
    # Swin family
    swin_window: int = 7
    swin_depths: tuple = (2, 2, 6, 2)
    swin_heads: tuple = (3, 6, 12, 24)
    swin_embed_dim: int = 96
    # common
    output_dim: int = 0             # 0 = no projection
    dropout: float = 0.0
    freeze: bool = False
    # "vit"  = plain ViT (final LN over all tokens)
    # "clip" = CLIP vision tower (pre-LN after embeddings; final LN on the
    #          CLS/pooled path only, tokens returned unnormalized) — needed
    #          for exact HF CLIP weight-import parity
    vit_style: str = "vit"
    activation: str = "gelu_tanh"   # gelu (exact) / quick_gelu for HF parity
    # LayerScale residual gains (DINOv2 towers); 0 = off
    layer_scale_init: float = 0.0
    # LayerNorm epsilon (1e-5 for torch-weight parity, Swin family)
    ln_eps: float = 1e-6
    dtype: str = "bfloat16"         # compute dtype (fp32 for parity tests)


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig(ConfigBase):
    backbone: str = "phobert"       # one of TEXT_BACKBONES
    vocab_size: int = 64001         # PhoBERT-base vocab
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    max_length: int = 64
    pooling: str = "cls"            # cls | mean | max
    type_vocab_size: int = 1
    output_dim: int = 0
    dropout: float = 0.1
    freeze: bool = False
    # "pre" = pre-LayerNorm (our native default, better stability);
    # "post" = BERT/PhoBERT/RoBERTa layout — required for exact HF
    # weight-import parity
    norm_style: str = "pre"
    activation: str = "gelu_tanh"
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class FusionConfig(ConfigBase):
    fusion_type: str = "cross_attention"   # one of FUSION_TYPES
    hidden_dim: int = 512
    num_heads: int = 8
    num_layers: int = 2
    dropout: float = 0.1
    # MuTAN tucker rank / MCAN flat-mlp dim / QFormer query count
    mutan_rank: int = 10
    mcan_flat_mlp_dim: int = 512
    mcan_flat_glimpses: int = 1
    num_query_tokens: int = 32


@dataclasses.dataclass(frozen=True)
class AnswerHeadConfig(ConfigBase):
    hidden_dims: tuple = (512,)
    dropout: float = 0.1
    activation: str = "gelu"


@dataclasses.dataclass(frozen=True)
class MoEModelConfig(ConfigBase):
    """MoE knobs as seen from the meta-architecture (full MoE subsystem
    config lives in vivqa_tpu/models/moe/config.py)."""
    use_moe: bool = False
    moe_type: str = "standard"      # standard | sparse | vqa | hierarchical
    num_experts: int = 4
    top_k: int = 2
    router_type: str = "topk"       # topk | noisy_topk | soft | expert_choice
    expert_hidden_dim: int = 1024
    capacity_factor: float = 1.25
    load_balance_weight: float = 0.01
    router_z_weight: float = 0.0
    moe_position: str = "fusion"    # fusion | decoder | both
    # VQA-MoE expert counts per type (reference generative_vqa_model.py:62-76)
    num_vision_experts: int = 2
    num_text_experts: int = 2
    num_multimodal_experts: int = 2
    num_specialized_experts: int = 0


@dataclasses.dataclass(frozen=True)
class KnowledgeModelConfig(ConfigBase):
    use_knowledge: bool = False
    knowledge_dim: int = 512
    num_retrieved: int = 5
    fusion_strategy: str = "attention"   # attention | concat | gated | add
    residual_weight: float = 0.5


@dataclasses.dataclass(frozen=True)
class VQAModelConfig(ConfigBase):
    """Classification VQA meta-arch config (reference vqa_config.py:171)."""
    visual: VisualEncoderConfig = dataclasses.field(default_factory=VisualEncoderConfig)
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    moe: MoEModelConfig = dataclasses.field(default_factory=MoEModelConfig)
    knowledge: KnowledgeModelConfig = dataclasses.field(default_factory=KnowledgeModelConfig)
    head: AnswerHeadConfig = dataclasses.field(default_factory=AnswerHeadConfig)
    num_answers: int = 1000
    label_smoothing: float = 0.0
    dtype: str = "bfloat16"         # compute dtype; params stay float32


@dataclasses.dataclass(frozen=True)
class GenerativeVQAConfig(ConfigBase):
    """Generative (encoder-decoder) VQA config (reference
    generative_vqa_model.py:27-104)."""
    visual: VisualEncoderConfig = dataclasses.field(default_factory=VisualEncoderConfig)
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    fusion_dim: int = 512
    fusion_layers: int = 3
    fusion_heads: int = 8
    moe: MoEModelConfig = dataclasses.field(default_factory=MoEModelConfig)
    # RAG: retrieved contexts become extra memory tokens the decoder
    # cross-attends over (fusion-in-decoder style; north-star config 5
    # "BARTpho encoder-decoder + FAISS hybrid RAG")
    knowledge: KnowledgeModelConfig = dataclasses.field(
        default_factory=KnowledgeModelConfig)
    # decoder
    vocab_size: int = 64001
    decoder_layers: int = 6
    decoder_heads: int = 8
    decoder_dim: int = 512
    decoder_ff_dim: int = 2048
    max_answer_length: int = 64
    max_question_length: int = 64
    tie_embeddings: bool = True
    dropout: float = 0.1
    label_smoothing: float = 0.1
    bos_token_id: int = 0
    eos_token_id: int = 2
    pad_token_id: int = 1
    dtype: str = "bfloat16"


def get_default_vietnamese_vqa_config(num_answers: int = 1000) -> VQAModelConfig:
    """CLIP-ViT-B/32 + PhoBERT-base + cross-attention fusion
    (reference: vqa_config.py:235)."""
    return VQAModelConfig(num_answers=num_answers)


def get_default_generative_vqa_config(vocab_size: int = 64001) -> GenerativeVQAConfig:
    return GenerativeVQAConfig(vocab_size=vocab_size)
