"""HF checkpoints -> the port's encoders (counterpart of
vivqa_tpu/models/convert.py).

The JAX package converts an ``AutoModel`` that ``transformers`` built;
here a converter reads the tensors of a local HF checkpoint by their key
names (``models/hf_files.py``: ``config.json`` plus safetensors or
``pytorch_model.bin``, no ``transformers``) with the HF config as a
dict, and returns the same flax-layout tree of f32 numpy arrays the JAX
converter returns. ``from_jax.load_flax_params`` loads that tree into the
port's module, so a converted tower can be compared with the JAX
package's leaf for leaf.

- ``convert_bert``: BERT / RoBERTa / PhoBERT -> TextEncoder (post-LN;
  RoBERTa-family positions are offset by 2, ``pos_offset``);
- ``convert_bart``: the mBART (BARTpho) encoder -> TextEncoder (pre-LN;
  ``config.scale_embedding``'s sqrt(d_model) folded into the token table);
- ``convert_vit``, ``convert_clip_vision``, ``convert_dinov2`` ->
  ViTEncoder; ``convert_resnet`` (BatchNorm folded into ResNet's frozen
  affine) -> ResNetEncoder; ``convert_swin`` -> SwinEncoder (fused qkv,
  PatchMerging's concatenation order permuted); ``convert_deberta`` ->
  DeBERTaEncoder.

``load_pretrained_text_encoder`` / ``load_pretrained_visual_encoder``
dispatch on ``model_type`` as the JAX loaders do, re-derive the encoder
config from the HF architecture and return (port encoder, converted
tree); ``graft_pretrained`` loads a converted tree into a model's tower
after checking it against the tower's own flax layout. Two quirks of the
reference are kept: the DINOv2 branch does not set ``image_size`` (a
518-px checkpoint under a 224-px pipeline fails at the graft, on
``pos_embed``'s shape), and DeBERTa has a converter but no loader
dispatch.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.models.config import (TextEncoderConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.models.hf_files import load_hf_checkpoint


def _t(x: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy (detached, f32)."""
    return np.asarray(x.detach().cpu().float().numpy(), np.float32)


def _attn_in(sd, prefix: str, heads: int):
    """HF Linear (out=D, in=D) -> flax MHA in-proj kernel (D, H, Dh)."""
    w, b = _t(sd[prefix + ".weight"]), _t(sd[prefix + ".bias"])
    D = w.shape[1]
    return {"kernel": w.T.reshape(D, heads, D // heads),
            "bias": b.reshape(heads, D // heads)}


def _attn_out(sd, prefix: str, heads: int):
    """HF out-proj Linear (out=D, in=D) -> flax (H, Dh, D)."""
    w = _t(sd[prefix + ".weight"])
    D = w.shape[0]
    return {"kernel": w.T.reshape(heads, D // heads, D),
            "bias": _t(sd[prefix + ".bias"])}


def _attn(sd, q: str, k: str, v: str, o: str, heads: int) -> Dict:
    return {"query": _attn_in(sd, q, heads), "key": _attn_in(sd, k, heads),
            "value": _attn_in(sd, v, heads), "out": _attn_out(sd, o, heads)}


def _linear(sd, prefix: str, bias: bool = True) -> Dict:
    out = {"kernel": _t(sd[prefix + ".weight"]).T}
    if bias:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def _ln(sd, prefix: str) -> Dict:
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"])}


def _conv_nhwc(sd, key: str) -> np.ndarray:
    """torch conv (out, in, kh, kw) -> flax (kh, kw, in, out)."""
    return _t(sd[key]).transpose(2, 3, 1, 0)


def convert_bert(sd: Mapping, hf_config: dict, config: TextEncoderConfig,
                 pos_offset: int = 0) -> Dict:
    """BertModel / RobertaModel -> TextEncoder params. For RoBERTa and
    PhoBERT pass pos_offset=2 (their position ids start at
    padding_idx + 1)."""
    assert config.norm_style == "post", \
        "HF BERT-family weights require norm_style='post'"
    L = config.max_length
    pos = _t(sd["embeddings.position_embeddings.weight"])[
        pos_offset: pos_offset + L]
    has_types = "embeddings.token_type_embeddings.weight" in sd
    if config.type_vocab_size <= 1 and has_types:
        # RoBERTa-family keeps a 1-row type embedding that is always
        # added; fold it into the position table (exact equivalence)
        pos = pos + _t(sd["embeddings.token_type_embeddings.weight"])[0]
    params: Dict = {
        "token_embed": {"embedding": _t(sd["embeddings.word_embeddings.weight"])},
        "pos_embed": {"embedding": pos},
        "ln_embed": _ln(sd, "embeddings.LayerNorm"),
    }
    if config.type_vocab_size > 1:
        params["type_embed"] = {
            "embedding": _t(sd["embeddings.token_type_embeddings.weight"])}
    H = config.num_heads
    for i in range(hf_config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        params[f"layers_{i}"] = {
            "self_attn": _attn(sd, p + "attention.self.query",
                               p + "attention.self.key",
                               p + "attention.self.value",
                               p + "attention.output.dense", H),
            "ln1": _ln(sd, p + "attention.output.LayerNorm"),
            "mlp": {"wi": _linear(sd, p + "intermediate.dense"),
                    "wo": _linear(sd, p + "output.dense")},
            "ln2": _ln(sd, p + "output.LayerNorm"),
        }
    return params


def convert_bart(sd: Mapping, hf_config: dict,
                 config: TextEncoderConfig) -> Dict:
    """The mBART (BARTpho) encoder -> TextEncoder params: layernorm_embedding
    after emb + pos (ln_embed), pre-LN layers (self_attn_layer_norm -> ln1,
    final_layer_norm -> ln2, fc1 / fc2 -> mlp wi / wo), mBART's final
    layer_norm -> ln_final. Learned positions are offset by 2 rows (BART's
    convention); the sqrt(d_model) embedding scale of
    ``scale_embedding`` is folded into the token table (exact: the table
    is only read by lookup). The mBART (pre-LN) layout only: plain BART is
    post-LN without a final layer_norm, which TextEncoder does not
    model."""
    assert config.norm_style == "pre", \
        "mBART/BARTpho weights require norm_style='pre'"
    assert "encoder.layer_norm.weight" in sd, \
        "convert_bart supports the mBART (pre-LN) encoder layout only"
    L = config.max_length
    scale = math.sqrt(hf_config["d_model"]) \
        if hf_config.get("scale_embedding") else 1.0
    params: Dict = {
        "token_embed": {"embedding":
                        _t(sd["encoder.embed_tokens.weight"]) * scale},
        # MBartLearnedPositionalEmbedding: the table has 2 extra leading
        # rows
        "pos_embed": {"embedding":
                      _t(sd["encoder.embed_positions.weight"])[2: 2 + L]},
        "ln_embed": _ln(sd, "encoder.layernorm_embedding"),
        "ln_final": _ln(sd, "encoder.layer_norm"),
    }
    H = config.num_heads
    for i in range(hf_config["encoder_layers"]):
        p = f"encoder.layers.{i}."
        params[f"layers_{i}"] = {
            "self_attn": _attn(sd, p + "self_attn.q_proj",
                               p + "self_attn.k_proj", p + "self_attn.v_proj",
                               p + "self_attn.out_proj", H),
            "ln1": _ln(sd, p + "self_attn_layer_norm"),
            "ln2": _ln(sd, p + "final_layer_norm"),
            "mlp": {"wi": _linear(sd, p + "fc1"),
                    "wo": _linear(sd, p + "fc2")},
        }
    return params


def _vit_layers(sd, hf_config: dict, config: VisualEncoderConfig,
                ln1: str, ln2: str, mlp: tuple) -> Dict:
    """The ViT-family HF layers (``encoder.layer.{i}``) -> flax layers."""
    H = config.num_heads
    out = {}
    for i in range(hf_config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        out[f"layers_{i}"] = {
            "self_attn": _attn(sd, p + "attention.attention.query",
                               p + "attention.attention.key",
                               p + "attention.attention.value",
                               p + "attention.output.dense", H),
            "ln1": _ln(sd, p + ln1),
            "ln2": _ln(sd, p + ln2),
            "mlp": {"wi": _linear(sd, p + mlp[0]),
                    "wo": _linear(sd, p + mlp[1])},
        }
    return out


def convert_vit(sd: Mapping, hf_config: dict,
                config: VisualEncoderConfig) -> Dict:
    """ViTModel -> ViTEncoder params."""
    params: Dict = {
        "cls_token": _t(sd["embeddings.cls_token"]),
        "pos_embed": _t(sd["embeddings.position_embeddings"]),
        "patch_embed": {
            "kernel": _conv_nhwc(
                sd, "embeddings.patch_embeddings.projection.weight"),
            "bias": _t(sd["embeddings.patch_embeddings.projection.bias"])},
        "ln_final": _ln(sd, "layernorm"),
    }
    params.update(_vit_layers(sd, hf_config, config, "layernorm_before",
                              "layernorm_after",
                              ("intermediate.dense", "output.dense")))
    return params


def convert_clip_vision(sd: Mapping, hf_config: dict,
                        config: VisualEncoderConfig) -> Dict:
    """CLIPVisionModel (or CLIPModel's vision tower) -> ViTEncoder
    (vit_style='clip') params. ``hf_config`` is the vision config."""
    assert config.vit_style == "clip"
    D = config.hidden_dim
    p = "vision_model."
    params: Dict = {
        "cls_token": _t(sd[p + "embeddings.class_embedding"]).reshape(1, 1, D),
        "pos_embed": _t(sd[p + "embeddings.position_embedding.weight"])[None],
        "patch_embed": {
            "kernel": _conv_nhwc(sd, p + "embeddings.patch_embedding.weight"),
            # CLIP's patch conv has no bias
            "bias": np.zeros((D,), np.float32)},
        "ln_pre": _ln(sd, p + "pre_layrnorm"),     # (sic: HF's name)
        "ln_final": _ln(sd, p + "post_layernorm"),
    }
    H = config.num_heads
    for i in range(hf_config["num_hidden_layers"]):
        q = f"{p}encoder.layers.{i}."
        params[f"layers_{i}"] = {
            "self_attn": _attn(sd, q + "self_attn.q_proj",
                               q + "self_attn.k_proj", q + "self_attn.v_proj",
                               q + "self_attn.out_proj", H),
            "ln1": _ln(sd, q + "layer_norm1"),
            "ln2": _ln(sd, q + "layer_norm2"),
            "mlp": {"wi": _linear(sd, q + "mlp.fc1"),
                    "wo": _linear(sd, q + "mlp.fc2")},
        }
    return params


# HF ResNet's BatchNorm2d keeps torch's default eps
_RESNET_BN_EPS = 1e-5


def _fold_bn(sd, prefix: str) -> Dict:
    """BatchNorm (eval) -> FrozenAffine {scale, bias}:
    y = x * g / sqrt(var + eps) + (b - mean * g / sqrt(var + eps))."""
    g, b = _t(sd[prefix + ".weight"]), _t(sd[prefix + ".bias"])
    mean = _t(sd[prefix + ".running_mean"])
    var = _t(sd[prefix + ".running_var"])
    scale = g / np.sqrt(var + np.float32(_RESNET_BN_EPS))
    return {"scale": scale, "bias": b - mean * scale}


def convert_resnet(sd: Mapping, hf_config: dict,
                   config: VisualEncoderConfig) -> Dict:
    """HF ResNetModel (microsoft/resnet-50's layout) -> ResNetEncoder
    (resnet_norm='frozen_bn') params, BatchNorm running statistics folded
    into per-channel affines. A block has a projection shortcut where the
    checkpoint holds one (HF's rule: a change of width or stride)."""
    assert config.resnet_norm == "frozen_bn", \
        "pretrained ResNet weights require resnet_norm='frozen_bn'"
    e = "embedder.embedder."
    params: Dict = {
        "stem": {"kernel": _conv_nhwc(sd, e + "convolution.weight")},
        "stem_norm": _fold_bn(sd, e + "normalization"),
    }
    convs = 3 if hf_config.get("layer_type", "bottleneck") == "bottleneck" \
        else 2
    for s, depth in enumerate(hf_config["depths"]):
        for b in range(depth):
            blk = f"encoder.stages.{s}.layers.{b}."
            p = {}
            for ci in range(convs):
                c = f"{blk}layer.{ci}."
                p[f"conv{ci + 1}"] = {"kernel": _conv_nhwc(
                    sd, c + "convolution.weight")}
                p[f"norm{ci + 1}"] = _fold_bn(sd, c + "normalization")
            if blk + "shortcut.convolution.weight" in sd:
                p["downsample"] = {"kernel": _conv_nhwc(
                    sd, blk + "shortcut.convolution.weight")}
                p["downsample_norm"] = _fold_bn(sd, blk
                                                + "shortcut.normalization")
            params[f"stage{s}_block{b}"] = p
    return params


def _swin_merge_perm(C: int) -> np.ndarray:
    """HF SwinPatchMerging concatenates 2x2 neighbourhoods in the order
    (0,0),(1,0),(0,1),(1,1); the encoder's reshape-transpose gives
    (0,0),(0,1),(1,0),(1,1). Permutation of HF's 4C input dims into
    ours."""
    groups = [0, 2, 1, 3]    # ours[k] = HF[groups[k]]
    return np.concatenate([np.arange(g * C, (g + 1) * C) for g in groups])


def convert_swin(sd: Mapping, hf_config: dict,
                 config: VisualEncoderConfig) -> Dict:
    """HF SwinModel -> SwinEncoder params: q/k/v fuse into the one ``qkv``
    Dense, the relative-position bias tables copy as they are (the same
    index convention), PatchMerging's weights are permuted for the 2x2
    concatenation order."""
    params: Dict = {
        "patch_embed": {
            "kernel": _conv_nhwc(
                sd, "embeddings.patch_embeddings.projection.weight"),
            "bias": _t(sd["embeddings.patch_embeddings.projection.bias"])},
        "ln_embed": _ln(sd, "embeddings.norm"),
        "ln_final": _ln(sd, "layernorm"),
    }
    depths = hf_config["depths"]
    for s, depth in enumerate(depths):
        for b in range(depth):
            p = f"encoder.layers.{s}.blocks.{b}."
            a = p + "attention.self."
            qkv_kernel = np.concatenate(
                [_t(sd[a + n + ".weight"]).T for n in ("query", "key",
                                                       "value")], axis=1)
            qkv_bias = np.concatenate([_t(sd[a + n + ".bias"])
                                       for n in ("query", "key", "value")])
            params[f"stage{s}_block{b}"] = {
                "ln1": _ln(sd, p + "layernorm_before"),
                "attn": {
                    "qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
                    "proj": _linear(sd, p + "attention.output.dense"),
                    "rel_pos_bias": _t(sd[a + "relative_position_bias_table"]),
                },
                "ln2": _ln(sd, p + "layernorm_after"),
                "mlp": {"wi": _linear(sd, p + "intermediate.dense"),
                        "wo": _linear(sd, p + "output.dense")},
            }
        if s < len(depths) - 1:
            d = f"encoder.layers.{s}.downsample."
            norm_w = _t(sd[d + "norm.weight"])
            perm = _swin_merge_perm(norm_w.shape[0] // 4)
            params[f"merge{s}"] = {
                "ln": {"scale": norm_w[perm],
                       "bias": _t(sd[d + "norm.bias"])[perm]},
                "reduction": {"kernel":
                              _t(sd[d + "reduction.weight"]).T[perm]},
            }
    return params


def convert_dinov2(sd: Mapping, hf_config: dict,
                   config: VisualEncoderConfig) -> Dict:
    """HF Dinov2Model -> ViTEncoder (layer_scale_init > 0) params."""
    assert config.layer_scale_init > 0, \
        "DINOv2 weights require layer_scale_init > 0 (LayerScale towers)"
    params: Dict = {
        "cls_token": _t(sd["embeddings.cls_token"]),
        "pos_embed": _t(sd["embeddings.position_embeddings"]),
        "patch_embed": {
            "kernel": _conv_nhwc(
                sd, "embeddings.patch_embeddings.projection.weight"),
            "bias": _t(sd["embeddings.patch_embeddings.projection.bias"])},
        "ln_final": _ln(sd, "layernorm"),
    }
    params.update(_vit_layers(sd, hf_config, config, "norm1", "norm2",
                              ("mlp.fc1", "mlp.fc2")))
    for i in range(hf_config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        params[f"layers_{i}"]["ls1_scale"] = _t(sd[p + "layer_scale1.lambda1"])
        params[f"layers_{i}"]["ls2_scale"] = _t(sd[p + "layer_scale2.lambda1"])
    return params


def convert_deberta(sd: Mapping, hf_config: dict, config) -> Dict:
    """HF DebertaV2Model -> DeBERTaEncoder params (``config`` a
    ``DeBERTaConfig``). The deberta-v3 layout only: share_att_key=True
    (shared q/k projections for the positional terms) and
    position_biased_input=False (relative positions only)."""
    assert hf_config.get("share_att_key", False), \
        "convert_deberta supports the v3 layout (share_att_key=True)"
    assert not hf_config.get("position_biased_input", True), \
        "convert_deberta expects position_biased_input=False"
    params: Dict = {
        "token_embed": {"embedding": _t(sd["embeddings.word_embeddings.weight"])},
        "ln_embed": _ln(sd, "embeddings.LayerNorm"),
        "rel_embeddings": _t(sd["encoder.rel_embeddings.weight"]),
    }
    if config.norm_rel_ebd:
        params["ln_rel"] = _ln(sd, "encoder.LayerNorm")
    for i in range(hf_config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        a = p + "attention."
        params[f"layers_{i}"] = {
            "self_attn": {
                "query_proj": _linear(sd, a + "self.query_proj"),
                "key_proj": _linear(sd, a + "self.key_proj"),
                "value_proj": _linear(sd, a + "self.value_proj"),
                "out_proj": _linear(sd, a + "output.dense"),
            },
            "ln1": _ln(sd, a + "output.LayerNorm"),
            "wi": _linear(sd, p + "intermediate.dense"),
            "wo": _linear(sd, p + "output.dense"),
            "ln2": _ln(sd, p + "output.LayerNorm"),
        }
    return params


def load_pretrained_text_encoder(name_or_path: str | os.PathLike,
                                 config: TextEncoderConfig):
    """A local HF checkpoint -> (TextEncoder, converted tree). Every
    architecture dimension is re-derived from the HF config, so the
    module's leaves are the converted tree's, as ``graft_pretrained``
    needs."""
    from vivqa_tpu_torch.models.encoders.text import TextEncoder
    hf, sd = load_hf_checkpoint(name_or_path)
    mt = hf.get("model_type", "")
    if mt in ("mbart", "bart"):
        # the BARTpho family: the encoder half of the seq2seq model,
        # pre-LN
        usable = hf["max_position_embeddings"]  # table carries +2 rows
        if config.max_length > usable:
            raise ValueError(
                f"pretrained text encoder '{name_or_path}' has only "
                f"{usable} usable positions but max_length="
                f"{config.max_length} was requested — reduce "
                f"data.max_question_length to <= {usable}")
        cfg = config.replace(
            norm_style="pre",
            activation=hf.get("activation_function", "gelu"),
            vocab_size=hf["vocab_size"],
            hidden_dim=hf["d_model"],
            num_layers=hf["encoder_layers"],
            num_heads=hf["encoder_attention_heads"],
            mlp_ratio=hf["encoder_ffn_dim"] / hf["d_model"],
            type_vocab_size=1)
        return TextEncoder(cfg), convert_bart(sd, hf, cfg)
    offset = 2 if mt in ("roberta", "phobert", "xlm-roberta") else 0
    usable = hf["max_position_embeddings"] - offset
    if config.max_length > usable:
        raise ValueError(
            f"pretrained text encoder '{name_or_path}' has only {usable} "
            f"usable positions (max_position_embeddings="
            f"{hf['max_position_embeddings']}, offset {offset}) but "
            f"max_length={config.max_length} was requested — reduce "
            f"data.max_question_length to <= {usable}")
    cfg = config.replace(norm_style="post", activation="gelu",
                         vocab_size=hf["vocab_size"],
                         hidden_dim=hf["hidden_size"],
                         num_layers=hf["num_hidden_layers"],
                         num_heads=hf["num_attention_heads"],
                         mlp_ratio=(hf["intermediate_size"]
                                    / hf["hidden_size"]),
                         type_vocab_size=hf.get("type_vocab_size", 1))
    return TextEncoder(cfg), convert_bert(sd, hf, cfg, pos_offset=offset)


def load_pretrained_visual_encoder(name_or_path: str | os.PathLike,
                                   config: VisualEncoderConfig):
    """A local HF checkpoint -> (encoder module, converted tree) for the
    visual towers: ViT, CLIP's vision tower, ResNet-50, Swin, DINOv2."""
    from vivqa_tpu_torch.models.encoders import (ResNetEncoder, SwinEncoder,
                                                 ViTEncoder)
    hf, sd = load_hf_checkpoint(name_or_path)
    mt = hf.get("model_type", "")
    if mt == "resnet":
        cfg = config.replace(
            backbone="resnet", resnet_norm="frozen_bn",
            resnet_width=hf["embedding_size"],
            resnet_stages=tuple(hf["depths"]))
        return ResNetEncoder(cfg), convert_resnet(sd, hf, cfg)
    if mt == "swin":
        cfg = config.replace(
            backbone="swin", swin_embed_dim=hf["embed_dim"],
            swin_depths=tuple(hf["depths"]),
            swin_heads=tuple(hf["num_heads"]),
            swin_window=hf["window_size"],
            activation="gelu", ln_eps=hf["layer_norm_eps"])
        return SwinEncoder(cfg), convert_swin(sd, hf, cfg)
    if mt == "dinov2":
        # image_size is not re-derived (the reference's own rule): the
        # checkpoint's position table must fit the configured size
        cfg = config.replace(
            backbone="dino", vit_style="vit", activation="gelu",
            hidden_dim=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            patch_size=hf["patch_size"],
            mlp_ratio=hf["mlp_ratio"],
            layer_scale_init=hf["layerscale_value"])
        return ViTEncoder(cfg), convert_dinov2(sd, hf, cfg)
    if mt in ("clip_vision_model", "clip"):
        vc = hf["vision_config"] if mt == "clip" else hf
        cfg = config.replace(backbone="clip", vit_style="clip",
                             activation="quick_gelu",
                             image_size=vc["image_size"],
                             patch_size=vc["patch_size"],
                             hidden_dim=vc["hidden_size"],
                             num_layers=vc["num_hidden_layers"],
                             num_heads=vc["num_attention_heads"],
                             mlp_ratio=(vc["intermediate_size"]
                                        / vc["hidden_size"]))
        return ViTEncoder(cfg), convert_clip_vision(sd, vc, cfg)
    if mt == "vit":
        cfg = config.replace(backbone="vit", vit_style="vit",
                             activation="gelu",
                             image_size=hf["image_size"],
                             patch_size=hf["patch_size"],
                             hidden_dim=hf["hidden_size"],
                             num_layers=hf["num_hidden_layers"],
                             num_heads=hf["num_attention_heads"],
                             mlp_ratio=(hf["intermediate_size"]
                                        / hf["hidden_size"]))
        return ViTEncoder(cfg), convert_vit(sd, hf, cfg)
    raise ValueError(f"no converter for model_type '{mt}'")


def graft_pretrained(model: nn.Module, tower: str, converted: Mapping,
                     log=None) -> nn.Module:
    """Load converted pretrained weights into ``model``'s ``tower`` in
    place; returns ``model``.

    Strict: the converted tree must have exactly the paths and leaf
    shapes of the tower's own flax layout, a mismatch raises before any
    weight is written (a config that does not describe the pretrained
    architecture would otherwise train from a half-grafted tower). An
    unknown tower raises ``KeyError``. The pipeline half of the
    reference's pretrained-backbone initialization
    (src/core/model_pipeline.py:303-352, vqa_model.py:83-98)."""
    from vivqa_tpu_torch.models.from_jax import (flatten_params,
                                                 flax_layouts, flax_paths,
                                                 load_flax_params)
    towers = dict(model.named_children())
    if tower not in towers:
        raise KeyError(f"model has no tower '{tower}' "
                       f"(have: {sorted(towers)})")
    module = towers[tower]
    paths = flax_paths(module)
    want = {paths[n]: tuple(layout[2])
            for n, layout in flax_layouts(module).items()}
    got = {p: tuple(np.shape(a))
           for p, a in flatten_params(converted).items()}
    if set(want) != set(got):
        missing, extra = sorted(set(want) - set(got)), \
            sorted(set(got) - set(want))
        raise ValueError(
            f"pretrained '{tower}' tree structure mismatch: the tower has "
            f"{missing[:1] or 'no other'} leaf the converted tree lacks, "
            f"the converted tree {extra[:1] or 'no other'} the tower lacks "
            f"({len(missing)} and {len(extra)} in all)")
    for path in sorted(want):
        if want[path] != got[path]:
            raise ValueError(
                f"pretrained '{tower}' leaf {path}: initialized shape "
                f"{want[path]} != converted {got[path]}")
    load_flax_params(module, converted)
    if log is not None:
        n = sum(int(np.size(a)) for a in flatten_params(converted).values())
        log.success(f"grafted pretrained weights into '{tower}' "
                    f"({n:,} params)")
    return model
