"""The port's initialiser (``models/layers.py:init_weights``) against
flax's initialisers, leaf by leaf.

Each model is initialised by the JAX package (its jitted ``init`` under
SEEDS keys) and by the port (``init_weights`` under SEEDS generators), at
the tests' small sizes; the port's leaves are laid out as flax's
(``from_jax.to_flax``). Pooled over the seeds, every leaf's standard
deviation is within 10% of flax's, a leaf flax makes constant (zeros,
ones, LayerScale's gain) has the same constant, and wherever flax
truncates (``lecun_normal``: Dense, DenseGeneral, Conv and the stacked
expert tensors) the port's largest |w| times sqrt(fan_in) is within
flax's bound of 2 / 0.87962566 = 2.27370, fan_in read as flax reads it:
a DenseGeneral query/key/value kernel (D, H, Dh) by its input axis, any
other leaf by the product of every axis but the last (so E * D for a
stacked (E, D, H) expert tensor).

The models reach every kind of leaf of the package: the flagship's
structure with the dense MoE, a two-type post-LN text tower (flax's
default ``nn.Embed`` init for ``type_embed``) and KnowledgeAttention;
the generative model with MoE in the fusion and the decoder and the
knowledge memory; the ablation study's VQA-MoE with every expert kind;
the zoo (ResNet + Q-Former + sparse MoE, Swin + single-stream +
hierarchical MoE, MuTAN with GLU experts, DeBERTa, the image
representations).
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from test_torch_support import padding_mask, shape_tree
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.encoders import deberta as JD
from vivqa_tpu.models.encoders import representation as JR
from vivqa_tpu.models.generative import GenerativeVQAModel as JGen
from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.encoders import deberta as PD
from vivqa_tpu_torch.models.encoders import representation as PR
from vivqa_tpu_torch.models.from_jax import flatten_params, to_flax
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.layers import init_weights
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel

torch.set_num_threads(1)

SEEDS = 12
STD_TOL = 0.10
TRUNC_BOUND = 2 / 0.87962566103423978       # 2.27370 of the std
K, DK = 3, 16                                # knowledge contexts, width


def _text(mod, **kw):
    return mod.TextEncoderConfig(**{
        "vocab_size": 50, "hidden_dim": 32, "num_layers": 1, "num_heads": 2,
        "max_length": 8, "dropout": 0.0, **kw})


def _cls_config(mod, visual=None, fusion=None, moe=None, **text):
    vis = visual or dict(image_size=16, patch_size=8, hidden_dim=32,
                         num_layers=1, num_heads=2)
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(**vis),
        text=_text(mod, **text),
        fusion=mod.FusionConfig(**{"fusion_type": "mcan", "hidden_dim": 32,
                                   "num_heads": 2, "num_layers": 1,
                                   "dropout": 0.0, "num_query_tokens": 4,
                                   "mutan_rank": 3, **(fusion or {})}),
        moe=mod.MoEModelConfig(**{"use_moe": True, "num_experts": 4,
                                  "top_k": 2, "expert_hidden_dim": 48,
                                  **(moe or {})}),
        head=mod.AnswerHeadConfig(dropout=0.0), num_answers=10)


def _flagship(mod):
    """The flagship's structure (ViT, text tower, MCAN, dense top-2 MoE,
    answer head) with BERT's two token types and the knowledge branch."""
    cfg = _cls_config(mod, backbone="bert", norm_style="post",
                      type_vocab_size=2)
    return cfg.replace(knowledge=mod.KnowledgeModelConfig(
        use_knowledge=True, knowledge_dim=DK, num_retrieved=K))


def _study(mod):
    """The ablation study's VQA-MoE: every expert kind, GLU-free experts
    and the six specialized ones, the soft router."""
    return _cls_config(mod, fusion={"fusion_type": "cross_attention"},
                       moe={"moe_type": "vqa", "router_type": "soft",
                            "num_vision_experts": 1, "num_text_experts": 1,
                            "num_multimodal_experts": 1,
                            "num_specialized_experts": 6,
                            "expert_hidden_dim": 32})


def _resnet(mod):
    return _cls_config(mod, visual=dict(backbone="resnet", image_size=32,
                                        resnet_width=32,
                                        resnet_stages=(1, 1)),
                       fusion={"fusion_type": "qformer"},
                       moe={"moe_type": "sparse"})


def _swin(mod):
    return _cls_config(mod, visual=dict(backbone="swin", image_size=32,
                                        swin_window=4, swin_depths=(2, 1),
                                        swin_heads=(2, 4),
                                        swin_embed_dim=32),
                       fusion={"fusion_type": "single_stream"},
                       moe={"moe_type": "hierarchical"})


def _mutan(mod):
    return _cls_config(mod, fusion={"fusion_type": "mutan"})


def _generative(mod):
    return mod.GenerativeVQAConfig(
        visual=mod.VisualEncoderConfig(image_size=16, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2),
        text=_text(mod), fusion_dim=32, fusion_layers=1, fusion_heads=2,
        moe=mod.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                               expert_hidden_dim=48, moe_position="both"),
        knowledge=mod.KnowledgeModelConfig(use_knowledge=True,
                                           knowledge_dim=DK,
                                           num_retrieved=K),
        vocab_size=50, decoder_layers=1, decoder_heads=2, decoder_dim=32,
        decoder_ff_dim=64, max_answer_length=6, dropout=0.0)


def _cls_inputs(size):
    rs = np.random.RandomState(0)
    mask = padding_mask([8, 5], 8)
    return (rs.standard_normal((2, size, size, 3)).astype(np.float32),
            (rs.randint(4, 50, (2, 8)) * mask).astype(np.int32), mask)


def _knowledge():
    return {"knowledge_embeddings": np.zeros((2, K, DK), np.float32),
            "knowledge_mask": np.ones((2, K), np.int32)}


DEBERTA = dict(vocab_size=60, hidden_dim=32, num_layers=1, num_heads=2,
               max_length=12, position_buckets=4, max_relative_positions=16,
               dropout=0.0)
REPR = dict(resnet_width=8, output_dim=16)


def _case(name):
    """(JAX module, its init args and kwargs, rng names, the port's
    module) of case ``name``."""
    if name in ("flagship", "study", "resnet_qformer_sparse",
                "swin_single_stream_hierarchical", "mutan"):
        build = {"flagship": _flagship, "study": _study,
                 "resnet_qformer_sparse": _resnet,
                 "swin_single_stream_hierarchical": _swin,
                 "mutan": _mutan}[name]
        cfg = build(JC)
        kw = _knowledge() if cfg.knowledge.use_knowledge else {}
        return (JModel(cfg), _cls_inputs(cfg.visual.image_size), kw,
                ("params", "router"), VietnameseVQAModel(build(PC)))
    if name == "generative":
        px, q, _ = _cls_inputs(16)
        dec = np.ones((2, 6), np.int32)
        return (JGen(_generative(JC)), (px, q, dec), _knowledge(),
                ("params", "router"), GenerativeVQAModel(_generative(PC)))
    if name == "deberta":
        mask = padding_mask((12, 7), 12)
        ids = (np.random.RandomState(1).randint(3, 60, (2, 12)) * mask
               ).astype(np.int32)
        return (JD.DeBERTaEncoder(JD.DeBERTaConfig(**DEBERTA)), (ids, mask),
                {}, ("params",), PD.DeBERTaEncoder(PD.DeBERTaConfig(**DEBERTA)))
    kind = name
    px = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    return (JR.create_image_representation(kind, JC.VisualEncoderConfig(
                **REPR)), (px,), {}, ("params",),
            PR.create_image_representation(kind,
                                           PC.VisualEncoderConfig(**REPR)))


CASES = ["flagship", "generative", "study", "resnet_qformer_sparse",
         "swin_single_stream_hierarchical", "mutan", "deberta",
         "region_based", "multi_resolution", "vision_token"]


def _fan_in(path: str, shape: tuple) -> int:
    """flax's fan_in of a ``lecun_normal`` leaf (DenseGeneral flattens the
    q/k/v kernel (D, H, Dh) to (D, H * Dh) and the out kernel (H, Dh, D)
    to (H * Dh, D) before the init)."""
    parent = path.split("/")[-2] if "/" in path else ""
    if len(shape) == 3 and path.endswith("kernel") \
            and parent in ("query", "key", "value"):
        return shape[0]
    return math.prod(shape[:-1])


@pytest.fixture(scope="module", params=CASES)
def draws(request):
    """{flax path: (flax's draws, the port's draws)}, each pooled over the
    seeds into one flat array."""
    jm, args, kw, rngs, port = _case(request.param)
    init = jax.jit(lambda key: jm.init({n: key for n in rngs}, *args,
                                       **kw)["params"])
    flax_draws = [flatten_params(jax.device_get(init(jax.random.PRNGKey(s))))
                  for s in range(SEEDS)]
    shapes = {p: a.shape for p, a in flax_draws[0].items()}
    port_draws = []
    for s in range(SEEDS):
        init_weights(port, torch.Generator().manual_seed(s))
        port_draws.append({p: a.copy() for p, a in to_flax(
            port, dict(port.named_parameters()), shapes).items()})
    assert set(port_draws[0]) == set(shapes), request.param
    return request.param, {
        p: tuple(np.concatenate([d[p].ravel() for d in ds]).astype(
            np.float64) for ds in (flax_draws, port_draws))
        for p in shapes}, shapes


def test_every_leaf_has_flax_std(draws):
    name, leaves, _ = draws
    bad = []
    for path, (want, got) in leaves.items():
        if want.std() == 0:
            # a constant leaf: zeros, ones, LayerScale's gain
            if not np.array_equal(np.unique(got), np.unique(want)):
                bad.append((path, "constant", np.unique(want)[:3],
                            np.unique(got)[:3]))
            continue
        ratio = got.std() / want.std()
        if abs(ratio - 1) > STD_TOL or abs(got.mean()) > 4 * want.std() \
                / math.sqrt(want.size):
            bad.append((path, want.size, float(want.std()),
                        float(got.std())))
    assert not bad, f"{name}: leaves whose law is not flax's: {bad}"


def test_truncated_leaves_stay_within_flax_bound(draws):
    name, leaves, shapes = draws
    truncated, bad = 0, []
    for path, (want, got) in leaves.items():
        std = want.std()
        if std == 0 or np.abs(want).max() > 2.5 * std:
            continue            # flax's law here is not truncated
        truncated += 1
        scale = math.sqrt(_fan_in(path, shapes[path]))
        # the fan_in is flax's: its own draws reach the bound and keep
        # within it
        assert 2.2 < np.abs(want).max() * scale <= TRUNC_BOUND + 1e-5, path
        if np.abs(got).max() * scale > TRUNC_BOUND + 1e-5:
            bad.append((path, float(np.abs(got).max() * scale)))
    assert truncated, name
    assert not bad, f"{name}: leaves past flax's truncation: {bad}"


def test_stacked_experts_fan_in_is_every_axis_but_the_last():
    """A stacked (E, D, H) expert tensor draws with std 1/sqrt(E * D),
    as flax's ``lecun_normal`` reads a 3-D shape, not 1/sqrt(D)."""
    from vivqa_tpu_torch.models.moe.layer import MOELayer
    from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                                   RouterConfig)
    layer = MOELayer(MoEConfig(num_experts=4, input_dim=512,
                               expert=ExpertConfig(hidden_dim=1024),
                               router=RouterConfig()))
    init_weights(layer, torch.Generator().manual_seed(0))
    for leaf, fan_in in (("experts_w_in", 4 * 512),
                         ("experts_w_out", 4 * 1024)):
        w = getattr(layer, leaf).detach().double()
        assert abs(w.std().item() * math.sqrt(fan_in) - 1) < 0.01, leaf
        assert w.abs().max().item() * math.sqrt(fan_in) <= TRUNC_BOUND + 1e-5


def test_init_draws_from_the_generator_alone():
    """Two models from one seed are equal leaf for leaf; another seed
    changes every random leaf."""
    cfg = _flagship(PC)
    a, b, c = (VietnameseVQAModel(cfg) for _ in range(3))
    for m, s in ((a, 3), (b, 3), (c, 4)):
        init_weights(m, torch.Generator().manual_seed(s))
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        if pa.unique().numel() > 1:        # a random leaf
            assert not torch.equal(pa, pc), n


def test_shape_tree_of_the_flagship_is_the_ports():
    """The flagship case's flax tree and the port's leaves pair one to
    one (the comparisons above read every leaf)."""
    jm, args, kw, rngs, port = _case("flagship")
    tree = jax.eval_shape(lambda: jm.init({n: jax.random.PRNGKey(0)
                                           for n in rngs}, *args, **kw))
    shapes = shape_tree(jax.device_get(tree["params"]))
    got = to_flax(port, dict(port.named_parameters()), shapes)
    assert {p: a.shape for p, a in got.items()} == shapes
