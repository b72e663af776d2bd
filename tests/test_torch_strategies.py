"""``vivqa_tpu_torch/train/strategies.py`` against the JAX package's
``trainable_mask``: every strategy at every epoch of a three-epoch run,
over the tiny classification model with MCAN, the MoE and the knowledge
branch, and over the tiny generative model (its ``question_encoder`` and
``decoder``), leaf by leaf through the flax paths."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_support import gen_config
from vivqa_tpu.train import strategies as JS
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import flax_layouts, flax_paths
from vivqa_tpu_torch.models.generative import create_generative_vqa_model
from vivqa_tpu_torch.models.vqa_model import create_vqa_model
from vivqa_tpu_torch.train import strategies as PS

torch.set_num_threads(1)


def _cls_model():
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=16, patch_size=8,
                                      hidden_dim=32, num_layers=1,
                                      num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=50, hidden_dim=32,
                                  num_layers=1, num_heads=2, max_length=8),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=32,
                               num_heads=2, num_layers=1),
        moe=PC.MoEModelConfig(use_moe=True, num_experts=2, top_k=1,
                              expert_hidden_dim=32),
        knowledge=PC.KnowledgeModelConfig(use_knowledge=True,
                                          knowledge_dim=32, num_retrieved=2),
        num_answers=7)
    return create_vqa_model(cfg, device="cpu")


MODELS = {"classification": _cls_model,
          "generative": lambda: create_generative_vqa_model(
              gen_config(PC), device="cpu")}


def _flax_tree(model) -> dict:
    """The model's params as a nested flax tree of zeros."""
    out = {}
    for name, (_, _, shape) in flax_layouts(model).items():
        node = out
        *heads, leaf = flax_paths(model)[name].split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[leaf] = np.zeros(shape, np.float32)
    return out


@pytest.mark.parametrize("kind", list(MODELS))
def test_trainable_mask_matches_jax(kind):
    model = MODELS[kind]()
    tree = _flax_tree(model)
    paths = flax_paths(model)
    heads = {p.split("/")[0] for p in paths.values()}
    if kind == "classification":
        assert {"visual_encoder", "text_encoder", "fusion", "moe",
                "answer_head", "knowledge_attn"} <= heads
    else:
        assert {"question_encoder", "decoder"} <= heads
    for strategy in PS.STRATEGIES:
        for epoch in range(3):
            want = JS.trainable_mask(tree, strategy, epoch, 3)
            got = PS.trainable_mask(model, strategy, epoch, 3)
            assert set(got) == set(dict(model.named_parameters()))
            for name, trainable in got.items():
                node = want
                for k in paths[name].split("/"):
                    node = node[k]
                assert trainable == bool(node), (strategy, epoch, name)


def test_gradual_unfreeze_stages_and_unnamed_heads():
    """Head, fusion, MoE and the knowledge modules (named by no rule)
    train from epoch 0; the text encoder from a third of the run, the
    visual encoder from two thirds; an unknown strategy raises."""
    model = _cls_model()
    paths = flax_paths(model)
    for epoch, text, visual in ((0, False, False), (1, True, False),
                                (2, True, True)):
        mask = PS.trainable_mask(model, "gradual_unfreeze", epoch, 3)
        for name, on in mask.items():
            head = paths[name].split("/")[0]
            want = {"text_encoder": text, "visual_encoder": visual}.get(
                head, True)
            assert on == want, (epoch, name)
    assert not any(PS.trainable_mask(model, "linear_probe")[n]
                   for n in paths if paths[n].startswith("knowledge"))
    with pytest.raises(ValueError, match="unknown strategy"):
        PS.trainable_mask(model, "freeze_all")
