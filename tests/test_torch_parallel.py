"""The port's ('data', 'model') mesh against the JAX package's, on the
CPU: ``MeshConfig.resolve``, the placement table leaf by leaf, and the
sharded train steps, decoding, expert parallelism and checkpoints of
``vivqa_tpu_torch`` on gloo ranks against the one-process port and
against JAX's ``ShardedStep`` on the same mesh shapes (the JAX side on
the 8 virtual CPU devices of tests/conftest.py).

The ranks are spawned once for the module (the ``setup`` fixture: four
gloo processes, meshes (2, 1) over ranks 0-1, (1, 2) over ranks 2-3 and
(2, 2) over all four) and every check reads what they returned. They import no JAX; the weights
and batches reach them as numpy (tests/test_torch_parallel_ranks.py).
Everything runs in f32 with dropout 0 (the forced-bf16 modules patched
to f32 in both packages), as tests/test_multichip.py does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from test_torch_support import forced_bf16_as_f32, gen_config, padding_mask
from vivqa_tpu.models import config as JC
from vivqa_tpu.parallel import mesh as JM
from vivqa_tpu.train import losses as JL
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu.train import state as JS
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import flatten_params, to_flax
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.parallel import mesh as PM
from vivqa_tpu_torch.parallel.collectives import Axis
from vivqa_tpu_torch.parallel.launch import start_ranks

torch.set_num_threads(1)

SHAPES = ((2, 1), (1, 2), (2, 2))
B = 8
IGNORE = -100


def cls_config(mod, vocab_size: int = 50):
    """A flagship-shaped classifier (ViT, text encoder, MCAN, MoE of 4
    experts top-2, answer head) at width 32 with 2 heads."""
    from test_torch_support import small_cls_config
    cfg = small_cls_config(mod)
    return cfg.replace(
        text=cfg.text.replace(vocab_size=vocab_size),
        moe=mod.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                               expert_hidden_dim=64))


def gen_cfg(mod, vocab_size: int = 50):
    """tests/test_torch_support's tiny generative model with a fusion MoE
    of 4 experts top-2 and no text-encoder dropout."""
    cfg = gen_config(mod, "float32", vocab_size=vocab_size, moe=(
        mod.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                           expert_hidden_dim=64)))
    return cfg.replace(text=cfg.text.replace(dropout=0.0))


def cls_batch(seed: int = 0) -> dict:
    """Rows 0-3 and 4-7 (the two data ranks' halves) differ in their
    images' scale, so the router loads of the halves differ."""
    rs = np.random.RandomState(seed)
    px = rs.standard_normal((B, 16, 16, 3)).astype(np.float32)
    px[B // 2:] *= 3.0
    mask = padding_mask([8, 6, 3, 8, 8, 2, 5, 7], 8)
    return {"pixel_values": px,
            "input_ids": (rs.randint(4, 50, (B, 8)) * mask).astype(np.int32),
            "attention_mask": mask,
            "labels": rs.randint(0, 10, (B,)).astype(np.int32)}


def gen_batch(seed: int = 1) -> dict:
    """Four rows; the first data rank's two rows carry 2 and 3 answer
    tokens, the second's 6 and 5, so a per-rank token mean would weigh
    them wrongly."""
    rs = np.random.RandomState(seed)
    n = 4
    qmask = padding_mask([8, 5, 8, 3], 8)
    dec = rs.randint(3, 50, (n, 6)).astype(np.int32)
    dec[:, 0] = 0
    lengths = [2, 3, 6, 5]
    dmask = padding_mask(lengths, 6)
    labels = rs.randint(3, 50, (n, 6)).astype(np.int32)
    labels[dmask == 0] = IGNORE
    return {"pixel_values": rs.standard_normal((n, 32, 32, 3)).astype(
                np.float32),
            "question_ids": (rs.randint(4, 50, (n, 8)) * qmask).astype(
                np.int32),
            "question_mask": qmask, "decoder_input_ids": dec,
            "decoder_mask": dmask, "labels": labels}


# -- JAX side -----------------------------------------------------------------
def _jax_model(kind: str):
    if kind == "cls":
        from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
        return JModel(cls_config(JC))
    from vivqa_tpu.models.generative import GenerativeVQAModel as JModel
    return JModel(gen_cfg(JC))


def _jax_loss(kind: str):
    def loss_fn(params, batch, rng, apply_fn):
        if kind == "cls":
            out = apply_fn({"params": params}, batch["pixel_values"],
                           batch["input_ids"], batch["attention_mask"],
                           deterministic=True)
            ce = JL.cross_entropy_loss(out["logits"], batch["labels"])
        else:
            out = apply_fn({"params": params}, batch["pixel_values"],
                           batch["question_ids"], batch["decoder_input_ids"],
                           batch["question_mask"], batch["decoder_mask"],
                           deterministic=True)
            ce = JL.cross_entropy_loss(out["logits"], batch["labels"],
                                       label_smoothing=0.1,
                                       ignore_index=IGNORE)
        return ce + 0.01 * out["aux_loss"], {}
    return loss_fn


def _jax_params(model, *args, seed: int = 5):
    """Seeded random weights in the JAX model's tree (its shapes from
    ``jax.eval_shape``, no init compiled): LayerNorm scales 1 + noise,
    kernels and tables normal over sqrt(fan-in), the rest normal(0.05)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, {"params": key, "router": key},
                            *args)["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        x = rs.standard_normal(s.shape).astype(np.float32)
        name = str(path[-1].key)
        if name == "scale":
            return 1.0 + 0.05 * x
        if len(s.shape) > 1:
            return x / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_sharded_steps(kind: str, model, params, batch, shape,
                      steps: int = 2) -> dict:
    """JAX's ShardedStep on a (data, model) mesh of CPU devices."""
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
        mesh, JS.make_train_step(_jax_loss(kind))).compile(state)
    dev = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                         batch_sh)
    out = {"loss": [], "grad_norm": []}
    for _ in range(steps):
        state, metrics = step(state, dev)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    out["params"] = flatten_params(jax.device_get(state.params))
    return out


def jax_decode(model, params, batch: dict, strategy: str, shape) -> tuple:
    """JAX's generate with the params placed by its rules on the mesh
    (tests/test_multichip.py:88-108)."""
    from vivqa_tpu.models.decoding import DecodeConfig, build_generate_fn
    cfg = model.config
    mesh = JM.create_mesh(JM.MeshConfig(*shape),
                          devices=jax.devices()[:shape[0] * shape[1]])
    gen = jax.jit(build_generate_fn(model, DecodeConfig(
        max_length=6, strategy=strategy, num_beams=4,
        bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id)))
    placed = jax.device_put(params, JM.shard_pytree_by_rules(params, mesh))
    bs = JM.batch_sharding(mesh)
    args = jax.device_put((jnp.asarray(batch["pixel_values"]),
                           jnp.asarray(batch["question_ids"]),
                           jnp.asarray(batch["question_mask"])),
                          (bs, bs, bs))
    seqs, scores = gen(placed, *args)
    return np.asarray(seqs), np.asarray(scores)


def sparse_config(mod):
    return mod.MoEConfig(num_experts=4, input_dim=32,
                         expert=mod.ExpertConfig(hidden_dim=64),
                         router=mod.RouterConfig(router_type="topk", top_k=2,
                                                 capacity_factor=0.5),
                         moe_type="sparse")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights of the three models, the ranks' results (started
    first, so that they run while the JAX side compiles) and JAX's:
    ShardedStep on (2, 2), decoding on (2, 2) and the sparse layer."""
    from vivqa_tpu.models.generative import GenerativeVQAModel as JGen
    from vivqa_tpu.models.moe import config as JMoE
    from vivqa_tpu.models.moe.layer import SparseMOELayer as JSparse
    from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JCls
    from vivqa_tpu_torch.models.moe import config as PMoE
    cb, gb = cls_batch(), gen_batch()
    jcls, jgen = JCls(cls_config(JC)), JGen(gen_cfg(JC))
    jsparse = JSparse(sparse_config(JMoE))
    x = np.random.RandomState(3).standard_normal((8, 4, 32)).astype(
        np.float32)
    x[4:] *= 2.0
    specs = {
        "cls": {"kind": "cls", "config": cls_config(PC), "batch": cb,
                "params": _jax_params(jcls, cb["pixel_values"],
                                      cb["input_ids"],
                                      cb["attention_mask"])},
        "gen": {"kind": "gen", "config": gen_cfg(PC), "batch": gb,
                "params": _jax_params(jgen, gb["pixel_values"],
                                      gb["question_ids"],
                                      gb["decoder_input_ids"])},
        "sparse": {"config": sparse_config(PMoE), "x": x,
                   "params": _jax_params(jsparse, x)}}
    ranks = start_ranks(R.mesh_job, 4, specs, SHAPES,
                        str(tmp_path_factory.mktemp("mesh_ckpt")))
    jax_out = {}
    with forced_bf16_as_f32():
        for kind, model in (("cls", jcls), ("gen", jgen)):
            jax_out[(kind, (2, 2))] = jax_sharded_steps(
                kind, model, specs[kind]["params"], specs[kind]["batch"],
                (2, 2))
    for strategy in ("greedy", "beam"):
        jax_out[("decode", strategy)] = jax_decode(
            jgen, specs["gen"]["params"], gb, strategy, (2, 2))
    y, aux = jsparse.apply({"params": specs["sparse"]["params"]},
                           jnp.asarray(x))
    jax_out["sparse"] = (np.asarray(y), float(aux["aux_loss"]))
    results = ranks.results()
    merged = {k: v for r in results for k, v in r.items() if k != "draws"}
    merged["draws"] = [r["draws"] for r in results]
    return specs, jax_out, merged


# -- MeshConfig and the placement table ---------------------------------------
@pytest.mark.parametrize("n,data,model", [
    (1, -1, 1), (4, -1, 1), (4, -1, 2), (4, 0, 4), (8, 4, 2), (8, 2, 4),
    (8, -1, 3), (4, 2, 1), (6, 3, 2), (2, 1, 2), (4, 3, 1), (3, -1, 2)])
def test_mesh_config_resolve_matches_jax(n, data, model):
    def run(mod):
        try:
            return mod.MeshConfig(data_axis=data, model_axis=model).resolve(n)
        except AssertionError as e:
            return ("AssertionError", str(e))
    assert run(PM) == run(JM)


def _layout_models(vocab_size: int):
    from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                                   RouterConfig)
    from vivqa_tpu_torch.models.moe.layer import SparseMOELayer
    sparse = SparseMOELayer(MoEConfig(
        num_experts=4, input_dim=32, expert=ExpertConfig(hidden_dim=64),
        router=RouterConfig(router_type="topk", top_k=2,
                            capacity_factor=1.0), moe_type="sparse"))
    return {"cls": VietnameseVQAModel(cls_config(PC, vocab_size)),
            "gen": GenerativeVQAModel(gen_cfg(PC, vocab_size)),
            "sparse": sparse}


@pytest.mark.parametrize("kind", ["cls", "gen", "sparse"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (4, 2)],
                         ids=str)
def test_placement_table_matches_jax(kind, shape):
    """Every parameter's (axis, flax dimension) is the JAX rules' on the
    same mesh, leaf by leaf; the odd vocabulary (51) and the 2 heads over
    model=4 fall back to replication in both."""
    port = _layout_models(51)[kind]
    jmesh = JM.create_mesh(JM.MeshConfig(*shape),
                           devices=jax.devices()[:shape[0] * shape[1]])
    pmesh = PM.Mesh(Axis("data", shape[0]), Axis("model", shape[1]),
                    torch.device("cpu"))
    got = PM.shard_pytree_by_rules(port, pmesh)
    paths = PM.flax_paths(port)
    layouts = PM.flax_layouts(port)
    shapes = {paths[n]: tuple(layouts[n][2]) for n in paths}
    tree = {}
    for path, s in shapes.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(s, jnp.float32)
    want = {path: tuple(sh.spec) for path, sh in JM._flatten_paths(
        JM.shard_pytree_by_rules(tree, jmesh))}
    n_split = 0
    for name, path in paths.items():
        spec = want[path]
        axes = [(i, a) for i, a in enumerate(spec) if a is not None]
        pl = got[name]
        assert ((pl.axis, pl.flax_dim) if pl.axis else None) == \
            (tuple(axes[0][::-1]) if axes else None), (path, spec, pl)
        n_split += bool(axes)
    if shape[1] > 1 and kind != "sparse" and shape[1] < 4:
        assert n_split > 0


# -- sharded train steps ------------------------------------------------------
def _flax_of(kind: str, spec: dict, params: dict) -> dict:
    port = (VietnameseVQAModel if kind == "cls" else GenerativeVQAModel)(
        spec["config"])
    shapes = {k: np.shape(v) for k, v in flatten_params(
        spec["params"]).items()}
    return to_flax(port, {n: torch.from_numpy(v) for n, v in params.items()},
                   shapes)


def _assert_leaves(got: dict, want: dict, rtol: float, msg: str,
                   zero_grad: set, embed_rtol: float | None = None,
                   floor: float = 0.0):
    """Each leaf within ``rtol`` of its largest value; the token tables
    within ``embed_rtol``. A leaf in ``zero_grad`` has an exact gradient
    of 0 (an attention key bias, AttFlat's score bias: a softmax ignores
    a shift), so Adam turns its rounding noise into a step of up to the
    learning rate: it is held to one such step. No leaf is held tighter
    than ``floor`` of the largest element of all (a gradient leaf that is
    0 exactly holds rounding noise only)."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        tol = max((embed_rtol if embed_rtol is not None
                   and "_embed/embedding" in path
                   else rtol) * float(np.abs(w).max()), floor * top)
        if path in zero_grad:
            tol = 1.1 * R.OPT.learning_rate
        diff = float(np.abs(got[path] - w).max())
        assert diff <= tol, f"{msg} {path}: max |diff| {diff} > {tol}"


@pytest.mark.parametrize("kind", ["cls", "gen"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sharded_step_matches_one_process_and_jax(setup, kind, shape):
    """Two AdamW steps (clipping, warmup-cosine) on the mesh: the loss,
    the grad norm, the gradient and every updated leaf, gathered, are the
    one-process step's within 1e-5 (of the leaf's largest value) and JAX's
    ShardedStep's on the (2, 2) mesh (GSPMD's global step; the losses
    within 1e-4, the port's one-device agreement with JAX; the embedding
    tables to a bf16 rounding: JAX's embedding backward rounds its
    gradient to bf16). The data ranks' router loads and answer lengths
    differ, so a per-rank aux loss or token mean would fail."""
    specs, jax_out, res = setup
    one, got = res[(kind, (1, 1))], res[(kind, shape)]
    want = jax_out[(kind, (2, 2))]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5)
        # the port's f32 generative loss is JAX's within 1e-4 on one
        # device too (tests/test_torch_gen_pipeline.py)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    grads = _flax_of(kind, specs[kind], one["grads"])
    top = max(float(np.abs(g).max()) for g in grads.values())
    zero_grad = {p for p, g in grads.items() if np.abs(g).max() <= 1e-6 * top}
    _assert_leaves(_flax_of(kind, specs[kind], got["grads"]), grads, 1e-5,
                   f"{shape} gradient vs one process", set(), floor=1e-6)
    got_flax = _flax_of(kind, specs[kind], got["params"])
    _assert_leaves(got_flax, _flax_of(kind, specs[kind], one["params"]),
                   1e-5, f"{shape} vs one process", zero_grad)
    _assert_leaves(got_flax, want["params"], 1e-5, f"{shape} vs JAX",
                   zero_grad, embed_rtol=4e-3)


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_tensor_parallel_decode_matches(setup, strategy, shape):
    """Greedy and 4-beam decoding with the heads, MLPs, experts and the
    tied vocabulary split over 'model' (and the rows over 'data'): the
    one-process tokens and scores, and JAX's on its mesh."""
    _, jax_out, res = setup
    seqs, scores = res[("decode", strategy, shape)]
    one_seqs, one_scores = res[("decode", strategy, (1, 1))]
    want_seqs, want_scores = jax_out[("decode", strategy)]
    np.testing.assert_array_equal(seqs, one_seqs)
    np.testing.assert_array_equal(seqs, want_seqs)
    np.testing.assert_allclose(scores, one_scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-5)


def test_sparse_moe_expert_parallel_matches(setup):
    """SparseMOELayer with its experts split over 'model' (1, 2): the
    one-process output and aux loss within 1e-6, and JAX's
    (tests/test_multichip.py:111-140)."""
    _, jax_out, res = setup
    one, got = res[("sparse", (1, 1))], res[("sparse", (1, 2))]
    np.testing.assert_allclose(got["y"], one["y"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["aux"], one["aux"], rtol=1e-6)
    np.testing.assert_allclose(got["y"], jax_out["sparse"][0], atol=1e-5)
    np.testing.assert_allclose(got["aux"], jax_out["sparse"][1], rtol=1e-5)


def test_sparse_moe_data_parallel_keeps_the_global_tokens(setup):
    """Under (2, 1) each rank holds half the tokens, yet the capacity is
    the global batch's and the kept (token, expert) pairs are those of
    the one-process layer on the global batch (capacity factor 0.5: some
    are dropped); so are the outputs and the aux loss."""
    _, _, res = setup
    one, got = res[("sparse", (1, 1))], res[("sparse", (2, 1))]
    assert got["cap"] == one["cap"]
    assert len(one["kept"]) < 8 * 4 * 2
    assert got["kept"] == one["kept"]
    np.testing.assert_allclose(got["y"], one["y"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["aux"], one["aux"], rtol=1e-6)


def test_checkpoint_from_a_mesh_resumes_on_one_process(setup):
    """A step on (2, 2), saved by rank 0 from the gathered shards, is the
    single-card format: one process loads its parameters and optimizer
    state as they were, whole, though the ranks held halves."""
    specs, _, res = setup
    ck = res["checkpoint"]
    assert sorted(ck["saved"]) == sorted(ck["resumed"])
    for n, v in ck["saved"].items():
        np.testing.assert_array_equal(ck["resumed"][n], v)
        np.testing.assert_array_equal(ck["nu_resumed"][n], ck["nu_saved"][n])
    halves = [n for n, s in ck["mesh_nu_shape"].items()
              if s != ck["nu_saved"][n].shape]
    assert any("query" in n for n in halves) and \
        any("experts_w_in" in n for n in halves)


def test_dropout_stream_per_data_rank(setup):
    """The step generator's stream: the 'data' ranks draw differently, a
    rank repeats its own draws at the same step, and the 'model' ranks of
    one data row draw alike (their replicated activations must drop
    alike)."""
    _, _, res = setup
    draws = res["draws"]
    d21 = [draws[r][(2, 1)] for r in (0, 1)]
    d12 = [draws[r][(1, 2)] for r in (2, 3)]
    for d in d21 + d12:
        assert d[0] == d[1] and d[0] != d[2]
    assert d21[0][0] != d21[1][0]
    assert d12[0] == d12[1]
