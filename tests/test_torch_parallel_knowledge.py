"""The knowledge (RAG) models on the ('data', 'model') mesh against the
one-process port and the JAX package, on the CPU.

``KnowledgeAttention``'s ``k_proj`` kernel is split over 'model' by the
rule ``attn/k_proj/kernel``, but a plain ``Dense`` has no
tensor-parallel form: it takes the gathered form of
``vivqa_tpu_torch/parallel/mesh.py`` (the slice at rest, all-gathered in
the forward, this rank's slice of the gradient kept), as GSPMD runs it
for the JAX package. The ranks (tests/test_torch_parallel_ranks.py:
``knowledge_job``) run the classification model on (1, 2) and (2, 2)
and the generative knowledge memory on (1, 2): two AdamW steps and an
evaluation forward each, f32 with dropout 0, held to one process and to
JAX's ``ShardedStep`` on (1, 2) (1e-5; the losses to JAX within 1e-4,
the port's one-device agreement). A walk of every model
configuration through ``logical_to_mesh`` on (1, 2) shows no split leaf
is left without a form, and the split leaves are JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from test_torch_parallel import (_assert_leaves, _jax_params, cls_batch,
                                 cls_config, gen_batch, gen_cfg)
from test_torch_support import forced_bf16_as_f32
from vivqa_tpu.models import config as JC
from vivqa_tpu.models import vqa_model as JVM
from vivqa_tpu.parallel import mesh as JM
from vivqa_tpu.train import losses as JL
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu.train import state as JS
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import (flatten_params, flax_layouts,
                                             flax_paths, to_flax)
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.parallel import mesh as PM
from vivqa_tpu_torch.parallel.collectives import Axis
from vivqa_tpu_torch.parallel.launch import start_ranks

torch.set_num_threads(1)

K, DK = 5, 24
IGNORE = -100


def knowledge(mod):
    return mod.KnowledgeModelConfig(use_knowledge=True, knowledge_dim=DK,
                                    num_retrieved=K)


def kcls_config(mod):
    return cls_config(mod).replace(knowledge=knowledge(mod))


def kgen_config(mod):
    return gen_cfg(mod).replace(knowledge=knowledge(mod))


def with_knowledge(batch: dict, seed: int) -> dict:
    """K contexts of width DK a row; rows keep 5, 3, 1, ... of them."""
    rs = np.random.RandomState(seed)
    n = len(next(iter(batch.values())))
    keep = np.resize([5, 3, 1, 4], n)
    return dict(batch, knowledge_embeddings=rs.standard_normal(
        (n, K, DK)).astype(np.float32),
        knowledge_mask=(np.arange(K)[None] < keep[:, None]).astype(np.int32))


@pytest.fixture(scope="module")
def setup():
    """The weights and batches, the ranks' results (started first) and
    JAX's: ShardedStep of each model on (1, 2), where 'model' splits
    ``k_proj``, and the evaluation logits."""
    from vivqa_tpu.models.generative import GenerativeVQAModel as JGen
    from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JCls
    cb, gb = with_knowledge(cls_batch(), 11), with_knowledge(gen_batch(), 12)
    jcls, jgen = JCls(kcls_config(JC)), JGen(kgen_config(JC))
    specs = {
        "kcls": {"kind": "cls", "config": kcls_config(PC), "batch": cb,
                 "params": _jax_params(
                     jcls, cb["pixel_values"], cb["input_ids"],
                     cb["attention_mask"], cb["knowledge_embeddings"],
                     cb["knowledge_mask"])},
        "kgen": {"kind": "gen", "config": kgen_config(PC), "batch": gb,
                 "params": _jax_params(
                     jgen, gb["pixel_values"], gb["question_ids"],
                     gb["decoder_input_ids"], gb["question_mask"],
                     gb["decoder_mask"], None, gb["knowledge_embeddings"],
                     gb["knowledge_mask"])}}
    ranks = start_ranks(R.knowledge_job, 4, specs)
    jax_out = {}
    with forced_bf16_as_f32(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JVM.KnowledgeAttention, "dtype", jnp.float32)
        for name, model in (("kcls", jcls), ("kgen", jgen)):
            jax_out[(name, "steps")] = jax_steps(
                name, model, specs[name]["params"], specs[name]["batch"],
                (1, 2))
            # jitted: op by op the tiny model's forward takes ~10 s here
            jax_out[(name, "logits")] = np.asarray(jax.jit(model.apply)(
                {"params": specs[name]["params"]},
                **_model_args(name, specs[name]["batch"]))["logits"])
    results = {k: v for r in ranks.results() for k, v in r.items()}
    return specs, jax_out, results


def _model_args(name: str, b: dict) -> dict:
    keys = (("pixel_values", "input_ids", "attention_mask")
            if name == "kcls" else
            ("pixel_values", "question_ids", "decoder_input_ids",
             "question_mask", "decoder_mask"))
    return {k: jnp.asarray(b[k]) for k in
            keys + ("knowledge_embeddings", "knowledge_mask")}


def _jax_loss(name: str):
    def loss_fn(params, batch, rng, apply_fn):
        out = apply_fn({"params": params}, **_model_args(name, batch),
                       deterministic=True)
        if name == "kcls":
            ce = JL.cross_entropy_loss(out["logits"], batch["labels"])
        else:
            ce = JL.cross_entropy_loss(out["logits"], batch["labels"],
                                       label_smoothing=0.1,
                                       ignore_index=IGNORE)
        return ce + 0.01 * out["aux_loss"], {}
    return loss_fn


def jax_steps(name: str, model, params, batch, shape, steps: int = 2
              ) -> dict:
    """JAX's ShardedStep on a (data, model) mesh of CPU devices, with the
    ranks' optimizer (tests/test_torch_parallel_ranks.py: OPT, SCHED)."""
    mesh = JM.create_mesh(JM.MeshConfig(*shape),
                          devices=jax.devices()[:shape[0] * shape[1]])
    o = R.OPT
    tx = JO.create_optimizer(
        JO.OptimizerConfig(learning_rate=o.learning_rate,
                           weight_decay=o.weight_decay,
                           grad_clip_norm=o.grad_clip_norm),
        JO.SchedulerConfig(name="warmup_cosine", warmup_steps=1,
                           total_steps=4), params=params)
    state = JS.place_state(JS.TrainState.create(
        model.apply, params, tx, jax.random.PRNGKey(0)), mesh)
    step, _, _, batch_sh = JS.ShardedStep(
        mesh, JS.make_train_step(_jax_loss(name))).compile(state)
    dev = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                         batch_sh)
    out = {"loss": [], "grad_norm": []}
    for _ in range(steps):
        state, metrics = step(state, dev)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    out["params"] = flatten_params(jax.device_get(state.params))
    return out


def _flax(spec: dict, tensors: dict) -> dict:
    port = (VietnameseVQAModel if spec["kind"] == "cls"
            else GenerativeVQAModel)(spec["config"])
    shapes = {k: np.shape(v) for k, v in flatten_params(
        spec["params"]).items()}
    return to_flax(port, {n: torch.from_numpy(v) for n, v in tensors.items()},
                   shapes)


CASES = [("kcls", (1, 2)), ("kcls", (2, 2)), ("kgen", (1, 2))]


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_knowledge_steps_match_one_process_and_jax(setup, name, shape):
    """Two steps on the mesh: loss, grad norm, every gradient leaf and
    every updated leaf (gathered) against one process within 1e-5 of the
    leaf's largest value, and against JAX's ShardedStep on (1, 2) (GSPMD's
    global step, which no mesh shape changes; the embedding tables to a
    bf16 rounding: JAX's embedding backward rounds its gradient to bf16).
    The knowledge projection gets a gradient."""
    specs, jax_out, res = setup
    spec = specs[name]
    got, one = res[(name, shape)]["train"], res[(name, (1, 1))]["train"]
    want = jax_out[(name, "steps")]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    grads = _flax(spec, one["grads"])
    top = max(float(np.abs(g).max()) for g in grads.values())
    zero_grad = {p for p, g in grads.items() if np.abs(g).max() <= 1e-6 * top}
    k_proj = ("knowledge_attn/k_proj/kernel" if name == "kcls"
              else "knowledge_proj/kernel")
    assert k_proj not in zero_grad
    _assert_leaves(_flax(spec, got["grads"]), grads, 1e-5,
                   f"{name} {shape} gradient vs one process", set(),
                   floor=1e-6)
    got_flax = _flax(spec, got["params"])
    _assert_leaves(got_flax, _flax(spec, one["params"]), 1e-5,
                   f"{name} {shape} vs one process", zero_grad)
    _assert_leaves(got_flax, want["params"], 1e-5, f"{name} {shape} vs JAX",
                   zero_grad, embed_rtol=4e-3)


@pytest.mark.parametrize("name,shape", CASES, ids=str)
def test_knowledge_eval_logits_match_one_process_and_jax(setup, name, shape):
    """An evaluation forward with the knowledge arrays on the mesh: the
    logits (gathered over 'data') against one process and JAX's apply
    within 1e-5."""
    _, jax_out, res = setup
    got = res[(name, shape)]["logits"]
    np.testing.assert_allclose(got, res[(name, (1, 1))]["logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_out[(name, "logits")], rtol=1e-5,
                               atol=1e-5)


def test_k_proj_is_split_and_gathered_on_the_model_axis(setup):
    """On (1, 2) the rules split the knowledge projection's output
    features: each rank holds 16 of its 32 rows, and the model's other
    split leaves are those of modules with a parallel form."""
    _, _, res = setup
    split = res[("kcls", (1, 2))]["split"]
    assert split["knowledge_attn.k_proj.weight"] == ("model", 0, (16, DK))
    assert "knowledge_attn.k_proj.bias" not in split
    assert split["knowledge_attn.context_attn.query.weight"][0] == "model"
    assert "knowledge_proj.weight" not in res[("kgen", (1, 2))]["split"]


# -- every configuration through logical_to_mesh --------------------------
MOE_TYPES = (None, "standard", "sparse", "vqa", "hierarchical")


def _walk_config(fusion: str, moe_type, use_knowledge: bool):
    """A classifier at width 64 (4 heads, 2 layers) with ``fusion``, the
    MoE of ``moe_type`` (None: none) and, with ``use_knowledge``,
    KnowledgeAttention."""
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=16, patch_size=8,
                                      hidden_dim=64, num_layers=2,
                                      num_heads=4),
        text=PC.TextEncoderConfig(vocab_size=52, hidden_dim=64,
                                  num_layers=2, num_heads=4, max_length=8),
        fusion=PC.FusionConfig(fusion_type=fusion, hidden_dim=64,
                               num_heads=4, num_layers=2),
        num_answers=10)
    if moe_type is not None:
        cfg = cfg.replace(moe=PC.MoEModelConfig(
            use_moe=True, moe_type=moe_type, num_experts=4, top_k=2,
            expert_hidden_dim=64, num_vision_experts=1, num_text_experts=1,
            num_multimodal_experts=1, num_specialized_experts=1))
    if use_knowledge:
        cfg = cfg.replace(knowledge=PC.KnowledgeModelConfig(
            use_knowledge=True, knowledge_dim=48))
    return cfg


def _walk_models():
    out = {}
    for fusion in PC.FUSION_TYPES:
        for moe_type in MOE_TYPES:
            for kn in (False, True):
                out[f"{fusion}-{moe_type}-{'knowledge' if kn else 'bare'}"] = (
                    "cls", _walk_config(fusion, moe_type, kn))
    base = _walk_config("mcan", "standard", True)
    out["swin"] = ("cls", base.replace(visual=PC.VisualEncoderConfig(
        backbone="swin", image_size=32, patch_size=4, swin_embed_dim=32,
        swin_depths=(2, 2), swin_heads=(2, 4), swin_window=4)))
    out["resnet"] = ("cls", base.replace(visual=PC.VisualEncoderConfig(
        backbone="resnet", image_size=32, resnet_width=32,
        resnet_stages=(1, 1, 1, 1))))
    for kn in (False, True):
        for moe in (None, "standard"):
            gcfg = gen_cfg(PC, 52)
            if moe is None:
                gcfg = gcfg.replace(moe=PC.MoEModelConfig())
            if kn:
                gcfg = gcfg.replace(knowledge=knowledge(PC))
            out[f"gen-{moe}-{'knowledge' if kn else 'bare'}"] = ("gen",
                                                                  gcfg)
    return out


WALK = _walk_models()


@pytest.mark.parametrize("name", sorted(WALK))
def test_every_configuration_places_on_the_model_axis(name):
    """``logical_to_mesh`` on (1, 2) raises for no configuration, and the
    leaves it splits are JAX's ``spec_for_path``'s, leaf by leaf."""
    kind, cfg = WALK[name]
    model = (VietnameseVQAModel if kind == "cls" else GenerativeVQAModel)(cfg)
    paths, layouts = flax_paths(model), flax_layouts(model)
    mesh = PM.Mesh(Axis("data", 1), Axis("model", 2, 0), torch.device("cpu"))
    jmesh = JM.create_mesh(JM.MeshConfig(1, 2), devices=jax.devices()[:2])
    sharding = PM.logical_to_mesh(model, mesh)
    for n, path in paths.items():
        spec = JM.spec_for_path(path, tuple(layouts[n][2]), jmesh)
        axes = [(a, i) for i, a in enumerate(spec) if a is not None]
        pl = sharding.placements[n]
        assert ((pl.axis, pl.flax_dim) if pl.axis else None) == \
            (axes[0] if axes else None), (path, spec, pl)
    if "knowledge" in name and kind == "cls":
        assert sharding.sharded("knowledge_attn.k_proj.weight")
