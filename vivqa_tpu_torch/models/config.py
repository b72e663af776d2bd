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


@dataclasses.dataclass(frozen=True)
class DecoderVQAConfig(ConfigBase):
    """Decoder-only generative VQA (``models/decoder_vqa.py``): a vision
    tower whose patch tokens, through a projector, start one causal
    sequence with the question and the answer, in a language model of
    DeepSeek-V3's layout (Kimi-VL-A3B's): RMSNorm, latent attention (MLA)
    with rotary positions, a dense SwiGLU in the first
    ``first_k_dense_replace`` layers and a sigmoid-routed MoE with
    shared experts after them, an untied vocabulary head. The keys are
    the published config.json's where it has them.

    ``experts_held`` [e0, e1) are the routed experts this chip holds of
    ``n_routed_experts``: the router scores all of them, each MoE layer
    computes the part of its output that the held experts give (expert
    parallelism without its exchange). ``vocab_size`` is the vocabulary
    as held here, the tokens' ids lie in it."""
    visual: VisualEncoderConfig = dataclasses.field(
        default_factory=lambda: VisualEncoderConfig(
            vit_style="clip", activation="quick_gelu"))
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264        # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408     # each routed expert's
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 800000.0
    rms_norm_eps: float = 1e-5
    n_routed_experts: int = 64
    experts_held: tuple = (0, 64)
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    # stand-ins for a correction bias trained to even the experts' loads
    # (moe/routed.py), both off at 0, both on the real tokens of a call's
    # first bias_fit_samples samples: > 0, an MoE layer's first training
    # call fits a bias still at zero once; > 0, every later training
    # call first moves the bias on by bias_update_iterations iterations
    # of that fit
    bias_fit_samples: int = 0
    bias_update_iterations: int = 0
    first_k_dense_replace: int = 1
    projector_ln_eps: float = 1e-5
    max_question_length: int = 64
    max_answer_length: int = 32
    bos_token_id: int = 0
    eos_token_id: int = 2
    pad_token_id: int = 1
    dtype: str = "bfloat16"
    # names the model in a pipeline's YAML ``model:`` section
    kind: str = "decoder_only"

    @property
    def num_image_tokens(self) -> int:
        return (self.visual.image_size // self.visual.patch_size) ** 2

    @property
    def max_positions(self) -> int:
        """The sequence's positions: image tokens, the question's, the
        answer's."""
        return (self.num_image_tokens + self.max_question_length
                + self.max_answer_length)


def get_default_vietnamese_vqa_config(num_answers: int = 1000) -> VQAModelConfig:
    """CLIP-ViT-B/32 + PhoBERT-base + cross-attention fusion
    (reference: vqa_config.py:235)."""
    return VQAModelConfig(num_answers=num_answers)


def get_default_generative_vqa_config(vocab_size: int = 64001) -> GenerativeVQAConfig:
    return GenerativeVQAConfig(vocab_size=vocab_size)
