"""Image representation tutorial on the port (counterpart of
examples/image_representation_examples.py).

Two layers of visual machinery, mirrored from the reference:

* **Backbone encoders** (used by the VQA meta-architectures) — ViT,
  CLIP-ViT, DINOv2-style ViT, ResNet, Swin; factory
  `create_visual_encoder` (reference meta_arch/vqa_model.py:51-131 +
  heads/image_representation.py:16-80).
* **Representation zoo** (standalone embedding strategies) —
  region-based pseudo-regions, multi-resolution FPN, Perceiver-style
  learned vision tokens, from-scratch ViT; factory
  `create_image_representation` (reference
  heads/image_representation.py:83-794).

Sections
  1. The encoder output contract
  2. Backbone zoo: ViT / CLIP / DINO / ResNet / Swin
  3. Config variants: patch size, depth, width, windows
  4. Representation zoo: region / FPN / vision-token / ViT
  5. Pretrained weights: the converter workflow (offline-safe demo)
  6. Freezing backbones for linear probing
  7. The JAX file's TPU notes, told of the H100

Run (on the card, or on the CPU with --device cpu; shapes are tiny):
    python3 -m vivqa_tpu_torch.examples.image_representation_examples [--device cpu]
"""

import json
import math
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.models.config import VisualEncoderConfig
from vivqa_tpu_torch.models.encoders import create_visual_encoder
from vivqa_tpu_torch.models.encoders.representation import \
    create_image_representation
from vivqa_tpu_torch.models.layers import init_weights


def params_of(module):
    return sum(p.numel() for p in module.parameters())


def built(module, device, seed: int = 0):
    """``module`` with weights drawn by flax's laws, in eval mode."""
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.to(device).eval()


def section_contract():
    banner("1. The encoder output contract")
    print("""Every visual encoder returns the same dict so fusion and the
meta-architecture never care which backbone produced it:

    out = encoder(pixel_values)                  # (B, H, W, 3) NHWC
    out["pooled"]  (B, D)       global image vector (CLS or pooled)
    out["tokens"]  (B, L, D)    spatial tokens (patches / grid cells)

NHWC, as the JAX package's inputs are: the loaders, checkpoints and
tests of both packages share one pixel layout; the port permutes to
NCHW inside the patch convolution, once per forward.""")


def section_backbones(device, px):
    banner("2. Backbone zoo")
    notes = {
        "vit": "from-scratch ViT (pre-LN, learned pos-embed)",
        "clip": "CLIP-vision variant: quick-GELU, pre-LN, CLS pooling —\n"
                "          weight-compatible with HF CLIPVisionModel",
        "dino": "DINOv2 variant: LayerScale + SwiGLU options wired for\n"
                "          facebook/dinov2 checkpoint conversion",
        "resnet": "bottleneck ResNet; GroupNorm from scratch or\n"
                "          frozen-BN-folded-to-affine for pretrained imports",
        "swin": "hierarchical windows with REAL shifted-window attention\n"
                "          and relative position bias",
    }
    for backbone in ("vit", "clip", "dino", "resnet", "swin"):
        cfg = VisualEncoderConfig(
            backbone=backbone, image_size=32, patch_size=16,
            hidden_dim=64, num_layers=2, num_heads=2,
            resnet_stages=(1, 1, 1, 1), resnet_width=32,
            swin_window=4, swin_depths=(1, 1), swin_heads=(2, 4),
            swin_embed_dim=16, output_dim=64)
        enc = built(create_visual_encoder(cfg), device)
        with torch.no_grad():
            out = enc(px)
        print(f"  {backbone:>8}: pooled={tuple(out['pooled'].shape)} "
              f"tokens={tuple(out['tokens'].shape)}  "
              f"params={params_of(enc):,}")
        print(f"          {notes[backbone]}")


def section_variants(device):
    banner("3. Config variants")
    print("Patch size trades sequence length against per-token detail;\n"
          "depth/width scale capacity. Shapes follow the config alone:\n")
    for image_size, patch in ((32, 16), (32, 8), (64, 16)):
        cfg = VisualEncoderConfig(backbone="vit", image_size=image_size,
                                  patch_size=patch, hidden_dim=64,
                                  num_layers=2, num_heads=2)
        enc = built(create_visual_encoder(cfg), device)
        px = torch.zeros(1, image_size, image_size, 3, device=device)
        with torch.no_grad():
            out = enc(px)
        n_tokens = out["tokens"].shape[1]
        print(f"  image {image_size}x{image_size}, patch {patch:>2} -> "
              f"{n_tokens:>3} tokens  (attention cost ~ L^2 = {n_tokens ** 2:,})")
    print("\nSwin sidesteps the L^2 by windowing: attention is local to\n"
          "shifted windows, so cost is linear in token count.")


def section_zoo(device, px):
    banner("4. Representation zoo")
    notes = {
        "region_based": "bottom-up-attention style grid pseudo-regions +\n"
                        "                   box-geometry features",
        "multi_resolution": "ResNet stage pyramid + lateral FPN fusion —\n"
                        "                   multi-scale tokens",
        "vision_token": "Perceiver/BLIP-2 style: learned query tokens\n"
                        "                   cross-attend into the pixel grid",
        "vit": "plain patch transformer (same module as backbone 'vit')",
    }
    # the vision tokens' 4 heads are resnet_width wide
    base = VisualEncoderConfig(image_size=64, resnet_width=32, output_dim=64)
    for kind in ("region_based", "multi_resolution", "vision_token", "vit"):
        cfg = base if kind != "vit" else base.replace(
            patch_size=16, hidden_dim=64, num_layers=2, num_heads=2)
        m = built(create_image_representation(kind, cfg), device)
        with torch.no_grad():
            out = m(px)
        print(f"  {kind:>17}: pooled={tuple(out['pooled'].shape)} "
              f"tokens={tuple(out['tokens'].shape)}  "
              f"params={params_of(m):,}")
        print(f"                   {notes[kind]}")


# a small CLIP vision tower in the HF layout (CLIPVisionConfig's names)
CLIP_DEMO = {"model_type": "clip",
             "vision_config": {"model_type": "clip_vision_model",
                               "hidden_size": 64, "intermediate_size": 128,
                               "num_hidden_layers": 2,
                               "num_attention_heads": 2, "image_size": 32,
                               "patch_size": 16, "hidden_act": "quick_gelu",
                               "layer_norm_eps": 1e-5}}


def seeded_clip_state(v: dict, seed: int = 0) -> dict:
    """A seeded CLIP vision state dict under HF's key names."""
    gen = torch.Generator().manual_seed(seed)
    D, Fd, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n = (v["image_size"] // P) ** 2 + 1
    sd = {}

    def w(key, *shape, base=0.0):
        sd[key] = base + 0.02 * torch.randn(shape, generator=gen)
    p = "vision_model."
    w(p + "embeddings.class_embedding", D)
    w(p + "embeddings.patch_embedding.weight", D, 3, P, P)
    w(p + "embeddings.position_embedding.weight", n, D)
    for ln in ("pre_layrnorm", "post_layernorm"):
        w(p + ln + ".weight", D, base=1.0)
        w(p + ln + ".bias", D)
    for i in range(v["num_hidden_layers"]):
        q = f"{p}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            w(q + f"self_attn.{proj}.weight", D, D)
            w(q + f"self_attn.{proj}.bias", D)
        for ln in ("layer_norm1", "layer_norm2"):
            w(q + ln + ".weight", D, base=1.0)
            w(q + ln + ".bias", D)
        w(q + "mlp.fc1.weight", Fd, D)
        w(q + "mlp.fc1.bias", Fd)
        w(q + "mlp.fc2.weight", D, Fd)
        w(q + "mlp.fc2.bias", D)
    return sd


def clip_vision_pooled(sd: dict, v: dict, px: torch.Tensor) -> torch.Tensor:
    """HF CLIPVisionModel's pooler_output, written out in plain torch:
    the independent reference the converted tower is held to."""
    p, eps = "vision_model.", v["layer_norm_eps"]
    H, D = v["num_attention_heads"], v["hidden_size"]

    def ln(x, key):
        return F.layer_norm(x, (D,), sd[key + ".weight"], sd[key + ".bias"],
                            eps)

    def lin(x, key):
        return F.linear(x, sd[key + ".weight"], sd[key + ".bias"])
    x = F.conv2d(px.permute(0, 3, 1, 2),
                 sd[p + "embeddings.patch_embedding.weight"],
                 stride=v["patch_size"]).flatten(2).transpose(1, 2)
    cls = sd[p + "embeddings.class_embedding"].expand(x.shape[0], 1, D)
    x = torch.cat([cls, x], 1) + sd[p + "embeddings.position_embedding.weight"]
    x = ln(x, p + "pre_layrnorm")
    B, L = x.shape[:2]
    for i in range(v["num_hidden_layers"]):
        q = f"{p}encoder.layers.{i}."
        h = ln(x, q + "layer_norm1")
        qkv = [lin(h, q + f"self_attn.{n}").view(B, L, H, D // H)
               .transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj")]
        att = torch.softmax(qkv[0] @ qkv[1].transpose(-1, -2)
                            / math.sqrt(D // H), -1) @ qkv[2]
        x = x + lin(att.transpose(1, 2).reshape(B, L, D),
                    q + "self_attn.out_proj")
        h = lin(ln(x, q + "layer_norm2"), q + "mlp.fc1")
        x = x + lin(h * torch.sigmoid(1.702 * h), q + "mlp.fc2")
    return ln(x[:, 0], p + "post_layernorm")


def section_pretrained(device):
    banner("5. Pretrained weights — the converter workflow")
    print("""The reference gets pretrained towers through torchvision/timm/HF
at call time. Here conversion is an explicit, testable step, and reads
the HF directory itself (models/hf_files.py: config.json, safetensors
or pytorch_model.bin, shards; no `transformers` needed):

    from vivqa_tpu_torch.models.convert import load_pretrained_visual_encoder
    enc, tree = load_pretrained_visual_encoder(
        "openai/clip-vit-base-patch32", VisualEncoderConfig(backbone="clip"))
    load_flax_params(enc, tree)                # or graft_pretrained(model,
    out = enc(pixel_values)                    #   "visual_encoder", tree)

Converters exist for CLIP-vision, ViT, DINOv2, ResNet-50 (BN folded
to per-channel affine -> resnet_norm="frozen_bn"), and Swin; each has
a numerical-parity test against the JAX package's converter
(tests/test_torch_convert.py).

Offline demo — a SEEDED CLIP vision tower written in the HF layout
(config.json + pytorch_model.bin, no download), read back:""")
    from vivqa_tpu_torch.models.convert import load_pretrained_visual_encoder
    from vivqa_tpu_torch.models.from_jax import load_flax_params
    v = CLIP_DEMO["vision_config"]
    sd = seeded_clip_state(v)
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "config.json").write_text(json.dumps(CLIP_DEMO))
        torch.save(sd, Path(d) / "pytorch_model.bin")
        cfg = VisualEncoderConfig(backbone="clip", image_size=32,
                                  patch_size=16, dtype="float32")
        enc, tree = load_pretrained_visual_encoder(d, cfg)
    enc = load_flax_params(enc, tree).to(device).eval()
    px = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ours = enc(px.to(device))["pooled"].float().cpu()
    theirs = clip_vision_pooled(sd, v, px)
    err = float((ours - theirs).abs().max())
    print(f"\n  converted 2-layer CLIP-vision: max |port - HF layout "
          f"reference| = {err:.2e}")


def section_freezing():
    banner("6. Freezing backbones")
    print("""Freezing is an OPTIMIZER concern, not a model flag: the trainer's
strategy system ('linear_probe', 'freeze_visual', 'gradual_unfreeze')
zero-masks updates for frozen subtrees, so the parameters stay one set
and the optimizer's state keeps its layout. See
vivqa_tpu_torch/train/strategies.py and tests/test_torch_strategies.py.""")


def section_tpu_notes():
    banner("7. TPU notes")
    print("""The JAX package's notes, and what the port does on the H100:
* All encoder matmuls run in bfloat16 (parameters stored in f32), on
  the tensor cores through cuBLAS; no GradScaler is needed, unlike the
  reference's AMP-fp16 path.
* Patchify is a conv with stride=patch — one large product, not an
  unfold+reshape.
* Every attention call goes through the port's CUDA kernels (tensor
  cores in bf16/f16), with the padding mask read in place.
* Image sizes are fixed per run: the data pipeline resizes on the host
  (PIL, or the C++ fast loader) to the config's image_size.""")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    gen = torch.Generator().manual_seed(0)
    px = torch.randn(2, 64, 64, 3, generator=gen).to(device)
    px_small = torch.randn(2, 32, 32, 3, generator=gen).to(device)

    section_contract()
    section_backbones(device, px_small)
    section_variants(device)
    section_zoo(device, px)
    section_pretrained(device)
    section_freezing()
    section_tpu_notes()

    banner("Done")
    print("Choose a backbone by config string:\n"
          '  VQAModelConfig(visual=VisualEncoderConfig(backbone="swin", ...))\n'
          "See python3 -m vivqa_tpu_torch.examples.complete_vqa_pipeline "
          "for the full model.")


if __name__ == "__main__":
    main()
