"""Plain float32 reference of the decoder-only VQA model on Kimi-VL-A3B's
language model (``vivqa_tpu_torch/models/decoder_vqa.py``), written from
the published equations (HF's ``modeling_deepseek_v3.py``, which
Kimi-VL's language model uses, and CLIP's vision tower), one sample at
a time over its real tokens only: no padding, no batching, no kernel.
It imports nothing of the port or of JAX, and takes the weights as a
dict of tensors by the port's parameter names.

- Vision (CLIP ViT): a patch convolution, the class token, learned
  positions, a pre-LayerNorm, pre-LN layers (attention with biases,
  an MLP with quick-gelu), the patch tokens without the final LayerNorm.
- Projector: LayerNorm, linear, exact GELU, linear.
- The sequence: the projected patch tokens, the question's real tokens,
  the answer's real tokens (BOS first); position p is token p.
- Layer: x + MLA(RMSNorm(x)), then + FFN(RMSNorm(.)); the dense SwiGLU
  in the first ``first_k_dense_replace`` layers, the MoE after them.
- MLA: q = W_q x split per head into nope + rope; [c, k_pe] = W_kva x;
  [k_nope, v] = W_kvb RMSNorm(c); rotary embedding in HF's form (each
  head vector's pairs laid out as halves, then ``rotate_half``) on q_pe
  and the one shared k_pe; causal softmax at 1/sqrt(nope + rope); W_o.
- MoE: s = sigmoid(W_r x) over all E experts in float32; top k of
  s + bias; weights s of those, normalised (``norm_topk_prob``) and
  scaled by ``routed_scaling_factor``; the experts in ``experts`` (all E
  unless a share is asked for) each run on their tokens; the shared
  SwiGLU on every token.
- Head: final RMSNorm, the untied vocabulary projection.

Departures: the correction bias is whatever the caller passes (zero by
default), as the port's unfitted one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def linear(p, name, x):
    y = x @ p[name + ".weight"].T
    bias = p.get(name + ".bias")
    return y if bias is None else y + bias


def rope(x, theta):
    """HF's ``apply_rotary_pos_emb`` of DeepSeek-V3 on x (H, L, d)."""
    H, L, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    freqs = torch.outer(torch.arange(L, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1).float().to(x.device)
    cos, sin = emb.cos(), emb.sin()
    x = x.view(H, L, d // 2, 2).transpose(3, 2).reshape(H, L, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rotated * sin


def swiglu(p, name, x):
    return linear(p, name + ".down_proj", F.silu(
        linear(p, name + ".gate_proj", x)) * linear(p, name + ".up_proj", x))


def mla(p, name, x, c):
    L = x.shape[0]
    H, nope, rope_d, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"],
                              c["qk_rope_head_dim"], c["v_head_dim"],
                              c["kv_lora_rank"])
    q = linear(p, name + ".q_proj", x).view(L, H, nope + rope_d) \
        .transpose(0, 1)
    ckv = linear(p, name + ".kv_a_proj", x)
    latent = rms_norm(ckv[:, :r], p[name + ".ln_kv.weight"],
                      c["rms_norm_eps"])
    kv = linear(p, name + ".kv_b_proj", latent).view(L, H, nope + vd) \
        .transpose(0, 1)
    k_pe = rope(ckv[None, :, r:], c["rope_theta"]).expand(H, L, rope_d)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    scores = q @ k.transpose(1, 2) / math.sqrt(nope + rope_d)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    o = (att @ kv[..., nope:]).transpose(0, 1).reshape(L, H * vd)
    return linear(p, name + ".o_proj", o)


def route(p, name, x, c, bias=None):
    """(expert ids (N, k), weights (N, k)) of the tokens x (N, D)."""
    s = torch.sigmoid(x.float() @ p[name + ".router.gate.weight"].float().T)
    choice = s if bias is None else s + bias
    idx = torch.topk(choice, c["num_experts_per_tok"], dim=-1).indices
    w = s.gather(1, idx)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"]


def moe(p, name, x, c, experts=None, bias=None, shared=True):
    """The MoE layer's output for the tokens x (N, D): the experts in
    ``experts`` (all held ones by default; an expert id e is row
    e - e0 of the stored stacks), plus the shared expert if ``shared``."""
    e0, e1 = c["experts_held"]
    experts = range(e0, e1) if experts is None else experts
    idx, w = route(p, name, x, c, bias)
    y = swiglu(p, name + ".shared", x) if shared else torch.zeros_like(x)
    for e in experts:
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        xe = x[tok]
        h = F.silu(xe @ p[name + ".experts_w_gate"][e - e0]) \
            * (xe @ p[name + ".experts_w_up"][e - e0])
        y = y.index_add(0, tok, w[tok, slot, None]
                        * (h @ p[name + ".experts_w_down"][e - e0]))
    return y


def vision_tokens(p, pixels, v):
    """CLIP's vision tower on one image (H, W, 3): the patch tokens."""
    w, P, D = p["visual_encoder.patch_embed.weight"], v["patch_size"], \
        v["hidden_dim"]
    x = F.conv2d(pixels.permute(2, 0, 1)[None], w,
                 p["visual_encoder.patch_embed.bias"], stride=P)
    x = x.flatten(2)[0].T
    x = torch.cat([p["visual_encoder.cls_token"][0], x]) \
        + p["visual_encoder.pos_embed"][0]
    x = layer_norm(x, p["visual_encoder.ln_pre.weight"],
                   p["visual_encoder.ln_pre.bias"], v["ln_eps"])
    H = v["num_heads"]
    for i in range(v["num_layers"]):
        n = f"visual_encoder.layers.{i}"
        h = layer_norm(x, p[n + ".ln1.weight"], p[n + ".ln1.bias"],
                       v["ln_eps"])
        q, k, val = (linear(p, f"{n}.self_attn.{r}", h).view(
            -1, H, D // H).transpose(0, 1) for r in ("query", "key", "value"))
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(D // H), -1)
        x = x + linear(p, n + ".self_attn.out",
                       (att @ val).transpose(0, 1).reshape(-1, D))
        h = layer_norm(x, p[n + ".ln2.weight"], p[n + ".ln2.bias"],
                       v["ln_eps"])
        h = linear(p, n + ".mlp.wi", h)
        x = x + linear(p, n + ".mlp.wo", h * torch.sigmoid(1.702 * h))
    return x[1:]


def hidden(p, c, pixels, question, answer, bias=None):
    """The last hidden states (L, D) of one sample's sequence (its real
    question and answer tokens given as 1-D id tensors)."""
    img = vision_tokens(p, pixels, c["visual"])
    img = linear(p, "projector.fc2", F.gelu(linear(
        p, "projector.fc1", layer_norm(
            img, p["projector.ln_in.weight"], p["projector.ln_in.bias"],
            c["projector_ln_eps"]))))
    table = p["token_embed.weight"]
    x = torch.cat([img, table[question], table[answer]])
    eps = c["rms_norm_eps"]
    for i in range(c["num_hidden_layers"]):
        n = f"layers.{i}"
        x = x + mla(p, n + ".attn", rms_norm(x, p[n + ".ln_attn.weight"],
                                             eps), c)
        h = rms_norm(x, p[n + ".ln_mlp.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(p, n + ".mlp", h)
        else:
            x = x + moe(p, n + ".moe", h, c,
                        bias=None if bias is None else bias[i])
    return x


def answer_logits(p, c, pixels, question, answer, bias=None):
    """Logits (len(answer), V) at the answer's positions."""
    x = hidden(p, c, pixels, question, answer, bias)[-len(answer):]
    return rms_norm(x, p["ln_final.weight"], c["rms_norm_eps"]) \
        @ p["lm_head.weight"].T


def loss(p, c, batch, label_smoothing=0.0, bias=None):
    """Mean label-smoothed cross-entropy over the labels that count, of
    every sample's sequence computed alone."""
    total, count = 0.0, 0
    for b in range(len(batch["pixel_values"])):
        qn = int(batch["question_mask"][b].sum())
        an = int(batch["decoder_mask"][b].sum())
        logits = answer_logits(p, c, batch["pixel_values"][b],
                               batch["question_ids"][b, :qn],
                               batch["decoder_input_ids"][b, :an], bias)
        labels = batch["labels"][b, :an]
        keep = labels != -100
        logp = torch.log_softmax(logits[keep], -1)
        nll = -logp.gather(1, labels[keep, None])[:, 0]
        total = total + ((1 - label_smoothing) * nll
                         - label_smoothing * logp.mean(-1)).sum()
        count += int(keep.sum())
    return total / count
