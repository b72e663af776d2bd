"""The rank side of tests/test_torch_parallel.py: functions that
``vivqa_tpu_torch.parallel.launch.run_ranks`` starts on gloo ranks. They
import no JAX (the ranks are spawned processes without the tests'
conftest); the tests give them numpy weights and batches and compare
what rank 0 returns with the JAX package in the test process. This file
holds no tests."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vivqa_tpu_torch.models.from_jax import load_flax_params
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.moe.layer import MOELayer
from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
from vivqa_tpu_torch.parallel.collectives import Axis
from vivqa_tpu_torch.parallel.mesh import (Mesh, MeshConfig, create_mesh,
                                           full_tensor, local_rows)
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (ShardedStep, TrainState,
                                         classification_loss_fn,
                                         generative_loss_fn,
                                         make_train_step, place_state)

torch.set_num_threads(1)

ONE = Mesh(Axis("data"), Axis("model"), torch.device("cpu"))
OPT = OptimizerConfig(learning_rate=1e-4, weight_decay=0.01,
                      grad_clip_norm=0.5)
SCHED = SchedulerConfig(name="warmup_cosine", warmup_steps=1, total_steps=4)


def t(a):
    a = np.asarray(a)
    return torch.from_numpy(a).long() if a.dtype.kind == "i" \
        else torch.from_numpy(a)


def build(spec: dict) -> torch.nn.Module:
    """The port's model of ``spec`` with its flax weights, in f32 (the
    forced-bf16 modules too) and without the experts' dropout."""
    cls = VietnameseVQAModel if spec["kind"] == "cls" else GenerativeVQAModel
    model = load_flax_params(cls(spec["config"]), spec["params"])
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
        if isinstance(m, MOELayer):
            m.dropout = 0.0
    return model


# the ranks of each mesh: (2, 1) and (1, 2) run side by side
MESH_RANKS = {(1, 1): (0,), (2, 1): (0, 1), (1, 2): (2, 3),
              (2, 2): (0, 1, 2, 3)}


def meshes(shapes, device="cpu") -> dict:
    """A mesh for each (data, model) shape over its ``MESH_RANKS`` (every
    rank calls; a rank outside a mesh gets None)."""
    return {s: create_mesh(MeshConfig(*s), device, ranks=MESH_RANKS[s])
            for s in shapes}


def _loss_fn(spec: dict):
    if spec["kind"] == "cls":
        return classification_loss_fn(aux_weight=0.01)
    return generative_loss_fn(label_smoothing=0.1, moe_aux_weight=0.01)


def train(spec: dict, mesh: Mesh, steps: int = 2) -> dict:
    """``steps`` steps of the global batch on ``mesh``: each step's loss
    and grad norm, and the parameters after them (whole, by torch
    name)."""
    model = build(spec)
    state = TrainState.create(model, create_optimizer(OPT, model, SCHED))
    place_state(state, mesh)
    step, _, _, _ = ShardedStep(mesh, make_train_step(
        _loss_fn(spec))).compile(state)
    batch = {k: t(v) for k, v in spec["batch"].items()}
    out = {"loss": [], "grad_norm": []}
    for _ in range(steps):
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    placements = (state.sharding.placements if state.sharding is not None
                  else {})
    # the last step's gradient (clipped), whole
    out["grads"] = {
        n: full_tensor(p.grad, placements[n], mesh).numpy()
        if n in placements else p.grad.numpy()
        for n, p in model.named_parameters()}
    out["params"] = {
        n: full_tensor(p.detach(), placements[n], mesh).numpy()
        if n in placements else p.detach().numpy()
        for n, p in model.named_parameters()}
    return out


def decode(spec: dict, mesh: Mesh, strategy: str) -> tuple:
    """Greedy or 4-beam tokens and scores of the spec's batch, each rank
    decoding its 'data' rows with its 'model' shard, gathered."""
    from vivqa_tpu_torch.models.decoding import (DecodeConfig,
                                                 build_generate_fn)
    from vivqa_tpu_torch.parallel.collectives import all_gather
    from vivqa_tpu_torch.parallel.mesh import logical_to_mesh
    model = build(spec).eval()
    if mesh.size > 1:
        logical_to_mesh(model, mesh)
    cfg = spec["config"]
    gen = build_generate_fn(model, DecodeConfig(
        max_length=6, strategy=strategy, num_beams=4,
        bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
        pad_token_id=cfg.pad_token_id))
    b = local_rows({k: t(v) for k, v in spec["batch"].items()}, mesh)
    seqs, scores = gen(b["pixel_values"], b["question_ids"],
                       b["question_mask"])
    return (all_gather(seqs, mesh.data).numpy(),
            all_gather(scores, mesh.data).numpy())


def sparse(spec: dict, mesh: Mesh) -> dict:
    """The sparse MoE layer on this rank's rows with its experts: the
    output and aux loss (rows gathered), the capacity and the kept
    (global token, expert) pairs."""
    from vivqa_tpu_torch.models.moe.layer import SparseMOELayer
    from vivqa_tpu_torch.parallel.collectives import all_gather
    from vivqa_tpu_torch.parallel.mesh import logical_to_mesh
    layer = load_flax_params(SparseMOELayer(spec["config"]),
                             spec["params"]).eval()
    if mesh.size > 1:
        logical_to_mesh(layer, mesh)
    x = local_rows({"x": t(spec["x"])}, mesh)["x"]
    with torch.no_grad():
        y, aux = layer(x)
        T = x.shape[0] * x.shape[1]
        cap, sorted_e, sorted_t, _, _, keep = layer.dispatch(
            layer.router(x).combine_weights.reshape(T, -1))
    pairs = all_gather(torch.stack([sorted_t + mesh.data.rank * T,
                                    sorted_e, keep.long()], 1), mesh.data)
    kept = pairs[pairs[:, 2] == 1, :2]
    return {"y": all_gather(y, mesh.data).numpy(),
            "aux": float(aux["aux_loss"]), "cap": cap,
            "kept": sorted(map(tuple, kept.tolist()))}


def checkpoint(spec: dict, mesh: Mesh, directory: str) -> dict:
    """One step on the mesh, saved by the main rank from the gathered
    state; the main rank then resumes it on one process."""
    from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                  CheckpointManager,
                                                  gathered_optimizer_state,
                                                  gathered_params)
    model = build(spec)
    state = TrainState.create(model, create_optimizer(OPT, model, SCHED))
    place_state(state, mesh)
    step, _, _, _ = ShardedStep(mesh, make_train_step(
        _loss_fn(spec))).compile(state)
    state, _ = step(state, {k: t(v) for k, v in spec["batch"].items()})
    params = gathered_params(model, state.sharding, mesh)
    opt = gathered_optimizer_state(state.optimizer, state.sharding, mesh)
    if not mesh.is_main:
        return {}
    ckpt = CheckpointManager(CheckpointConfig(directory=directory,
                                              keep_best=False))
    ckpt.save(state.step, {"params": params, "optimizer": opt})
    restored, _ = ckpt.restore()
    fresh = build(spec)
    fresh.load_state_dict(restored["params"])
    fresh_opt = create_optimizer(OPT, fresh, SCHED)
    fresh_opt.load_state_dict(restored["optimizer"])
    return {"saved": {n: v.numpy() for n, v in params.items()},
            "resumed": {n: p.detach().numpy()
                        for n, p in fresh.named_parameters()},
            "nu_saved": {n: v.numpy()
                         for n, v in opt["state"]["nu"].items()},
            "nu_resumed": {n: v.numpy() for n, v in zip(
                fresh_opt.names, fresh_opt.state["nu"])},
            "mesh_nu_shape": {n: tuple(v.shape) for n, v in zip(
                state.optimizer.names, state.optimizer.state["nu"])}}


def dropout_draws(spec: dict, mesh: Mesh) -> list:
    """This rank's first draws of the step generator at steps 0, 0, 1."""
    model = build(spec)
    state = TrainState.create(model, create_optimizer(OPT, model, SCHED))
    place_state(state, mesh)
    draws = []
    for step in (0, 0, 1):
        state.step = step
        draws.append(torch.rand(4, generator=state.step_generator()).tolist())
    return draws


def mesh_job(rank: int, specs: dict, shapes, directory: str) -> dict:
    """Everything the tests hold, on one spawn of four ranks: the train
    steps of every spec on one process and on each mesh, greedy and
    4-beam decoding, the sparse layer, a checkpoint from (2, 2) and the
    dropout streams. Ranks 0-1 run (2, 1) while ranks 2-3 run (1, 2),
    then all four (2, 2); the one-process references are spread over the
    ranks. Each result comes from the first rank of its mesh."""
    ms = meshes(shapes)
    out = {"draws": {}}

    def keep(key, mesh, fn, *args):
        if mesh is not None:
            res = fn(*args, mesh)
            if dist.get_rank() == MESH_RANKS[key[-1]][0]:
                out[key] = res
    first = ((2, 1), (1, 2))
    for name in ("cls", "gen"):
        for s in first:
            keep((name, s), ms[s], train, specs[name])
    for strategy in ("greedy", "beam"):
        keep(("decode", strategy, (1, 2)), ms[(1, 2)],
             lambda m, st=strategy: decode(specs["gen"], m, st))
    for s in first:
        keep(("sparse", s), ms[s], sparse, specs["sparse"])
        if ms[s] is not None:
            out["draws"][s] = dropout_draws(specs["cls"], ms[s])
    if rank < 2:
        name = ("cls", "gen")[rank]
        out[(name, (1, 1))] = train(specs[name], ONE)
    elif rank == 2:
        for strategy in ("greedy", "beam"):
            out[("decode", strategy, (1, 1))] = decode(specs["gen"], ONE,
                                                       strategy)
    else:
        out[("sparse", (1, 1))] = sparse(specs["sparse"], ONE)
    m = ms[(2, 2)]
    for name in ("cls", "gen"):
        keep((name, (2, 2)), m, train, specs[name])
    for strategy in ("greedy", "beam"):
        keep(("decode", strategy, (2, 2)), m,
             lambda m_, st=strategy: decode(specs["gen"], m_, st))
    ck = checkpoint(specs["gen"], m, directory)
    if rank == 0:
        out["checkpoint"] = ck
    return out


def as_f32_pipeline():
    """``ModelPipeline.run`` with every bf16 module of the built model set
    to compute in f32 (the forced-bf16 MCAN and answer head too)."""
    from vivqa_tpu_torch.pipelines import model_pipeline as MP
    run = MP.ModelPipeline.run

    def run_f32(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        for m in out.model.modules():
            if getattr(m, "dtype", None) == torch.bfloat16:
                m.dtype = torch.float32
        return out
    MP.ModelPipeline.run = run_f32


def run_pipeline(cfg) -> dict:
    """The classification CLI's pipeline on this process's mesh: its
    summary (history, final metrics), f32 throughout."""
    from vivqa_tpu_torch.pipelines.vqa_pipeline import VQAPipeline
    as_f32_pipeline()
    return VQAPipeline(cfg).run()


def pipeline_job(rank: int, cfg) -> dict:
    return run_pipeline(cfg)


# -- tests/test_torch_parallel_knowledge.py ----------------------------------
def eval_logits(spec: dict, mesh: Mesh) -> np.ndarray:
    """The logits of one evaluation forward of the spec's batch (its
    knowledge arrays too), each rank its 'data' rows, gathered."""
    from vivqa_tpu_torch.parallel.collectives import all_gather
    from vivqa_tpu_torch.parallel.mesh import logical_to_mesh
    from vivqa_tpu_torch.train.state import knowledge_of
    model = build(spec).eval()
    if mesh.size > 1:
        logical_to_mesh(model, mesh)
    b = local_rows({k: t(v) for k, v in spec["batch"].items()}, mesh)
    with torch.no_grad():
        if spec["kind"] == "cls":
            out = model(b["pixel_values"], b["input_ids"],
                        b["attention_mask"], **knowledge_of(b))
        else:
            out = model(b["pixel_values"], b["question_ids"],
                        b["decoder_input_ids"], b["question_mask"],
                        b["decoder_mask"], **knowledge_of(b))
    return all_gather(out["logits"], mesh.data).numpy()


def split_leaves(spec: dict, mesh: Mesh) -> dict:
    """{torch name: (axis, torch dim, this rank's shape)} of the leaves
    the rules split on ``mesh``."""
    from vivqa_tpu_torch.parallel.mesh import logical_to_mesh
    model = build(spec)
    sharding = logical_to_mesh(model, mesh)
    params = dict(model.named_parameters())
    return {n: (pl.axis, pl.dim, tuple(params[n].shape))
            for n, pl in sharding.placements.items() if pl.axis}


def knowledge_job(rank: int, specs: dict) -> dict:
    """The knowledge models on gloo ranks: the generative one on (1, 2)
    over ranks 0-1 while the classification one runs on (1, 2) over
    ranks 2-3; then their one-process references on ranks 0 and 1; then
    the classification one on (2, 2). Each: two train steps and an
    evaluation forward."""
    pairs = {"kgen": create_mesh(MeshConfig(1, 2), "cpu", ranks=(0, 1)),
             "kcls": create_mesh(MeshConfig(1, 2), "cpu", ranks=(2, 3))}
    full = create_mesh(MeshConfig(2, 2), "cpu")
    out = {}
    for name, mesh in pairs.items():
        if mesh is not None:
            res = {"train": train(specs[name], mesh),
                   "logits": eval_logits(specs[name], mesh),
                   "split": split_leaves(specs[name], mesh)}
            if mesh.is_main or dist.get_rank() == 2:
                out[(name, (1, 2))] = res
    if rank < 2:
        name = ("kcls", "kgen")[rank]
        out[(name, (1, 1))] = {"train": train(specs[name], ONE),
                               "logits": eval_logits(specs[name], ONE)}
    res = {"train": train(specs["kcls"], full),
           "logits": eval_logits(specs["kcls"], full)}
    if rank == 0:
        out[("kcls", (2, 2))] = res
    return out


# -- tests/test_torch_parallel_adafactor.py ----------------------------------
ADA_OPT = OptimizerConfig(name="adafactor", learning_rate=1e-2,
                          weight_decay=0.01, grad_clip_norm=1.0)


class AdaNet(torch.nn.Module):
    """Leaves of every case adafactor meets under 'model' (f32): the MLP
    kernels (128, 512) and (512, 128), split on 512, the largest of each,
    which one statistic averages over; attention kernels (256, 2, 128)
    and (2, 128, 256) and stacked experts (2, 128, 256), split on a
    dimension both statistics keep; the knowledge projection (384, 256),
    split on its second largest dimension in the gathered form; and
    unfactored biases and LayerNorms."""

    def __init__(self):
        from vivqa_tpu_torch.models.layers import (
            LayerNorm, MlpBlock, MultiHeadDotProductAttention)
        from vivqa_tpu_torch.models.moe.config import (ExpertConfig,
                                                       MoEConfig)
        from vivqa_tpu_torch.models.vqa_model import KnowledgeAttention
        super().__init__()
        self.mlp = MlpBlock(128, 512, dtype=torch.float32)
        self.self_attn = MultiHeadDotProductAttention(256, 2,
                                                      dtype=torch.float32)
        self.moe = MOELayer(MoEConfig(num_experts=2, input_dim=128,
                                      expert=ExpertConfig(hidden_dim=256)))
        self.knowledge_attn = KnowledgeAttention(384, 256, num_heads=2)
        self.ln = LayerNorm(256, dtype=None)


def ada_model() -> AdaNet:
    torch.manual_seed(0)
    model = AdaNet()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(0.05 * torch.randn_like(p) + (n.endswith("ln.weight")))
    return model


def ada_grads(shapes: dict, step: int) -> dict:
    """The global batch's gradients of update ``step`` (whole, by torch
    name)."""
    rs = np.random.RandomState(100 + step)
    return {n: torch.from_numpy((0.1 * rs.standard_normal(s)).astype(
        np.float32)) for n, s in shapes.items()}


def ada_state(mesh: Mesh):
    from vivqa_tpu_torch.train.state import TrainState
    model = ada_model()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state = TrainState.create(model, create_optimizer(ADA_OPT, model))
    place_state(state, mesh)
    return state, shapes


def ada_step(state, shapes: dict, step: int, mesh: Mesh) -> float:
    """One update from ``ada_grads``: each rank holds its slice of a split
    leaf's gradient, 1/m of a partial (column-parallel bias) one, and the
    whole of the others."""
    from vivqa_tpu_torch.parallel.mesh import shard_tensor
    grads = ada_grads(shapes, step)
    sharding = state.sharding
    for n, p in state.model.named_parameters():
        g = grads[n]
        if sharding is not None and sharding.sharded(n):
            g = shard_tensor(g, sharding.placements[n], mesh)
        elif sharding is not None and n in sharding.partial:
            g = g / mesh.model.size
        p.grad = g.clone()
    return float(state.optimizer.step())


def ada_whole(state, mesh: Mesh) -> dict:
    """The parameters and the optimizer's per-parameter state, whole."""
    from vivqa_tpu_torch.train.checkpoint import (gathered_optimizer_state,
                                                  gathered_params)
    opt = gathered_optimizer_state(state.optimizer, state.sharding, mesh)
    # copies: on one process the whole tensors are the live ones
    return {"params": {n: v.numpy().copy() for n, v in gathered_params(
                state.model, state.sharding, mesh).items()},
            "state": {f: {n: v.numpy().copy() for n, v in ts.items()}
                      for f, ts in opt["state"].items()},
            "count": opt["count"]}


def adafactor_run(mesh: Mesh, directory: str) -> dict:
    """Three updates on ``mesh`` (the state whole after the second and
    the third, each update's grad norm); then the checkpoint round trip:
    rank 0 saves the whole state after two updates, a fresh state on the
    same mesh resumes from it and takes the third."""
    from vivqa_tpu_torch.parallel.mesh import barrier
    from vivqa_tpu_torch.pipelines.common import load_params
    from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                  CheckpointManager,
                                                  gathered_optimizer_state)
    state, shapes = ada_state(mesh)
    out = {"norms": [ada_step(state, shapes, s, mesh) for s in range(2)],
           "local_shapes": {
               f: {n: tuple(t.shape) for n, t in zip(
                   state.optimizer.names, ts)}
               for f, ts in state.optimizer.state.items()}}
    out["after2"] = ada_whole(state, mesh)
    whole_opt = gathered_optimizer_state(state.optimizer, state.sharding,
                                         mesh)
    ckpt = CheckpointManager(CheckpointConfig(directory=directory,
                                              keep_best=False))
    if mesh.data.rank == 0 and mesh.model.rank == 0:
        ckpt.save(2, {"params": {n: torch.from_numpy(v) for n, v in
                                 out["after2"]["params"].items()},
                      "optimizer": whole_opt})
    barrier(mesh)
    out["norms"].append(ada_step(state, shapes, 2, mesh))
    out["after3"] = ada_whole(state, mesh)
    resumed, _ = ada_state(mesh)
    restored, _ = ckpt.restore()
    load_params(resumed.model, restored["params"], resumed.sharding, mesh)
    resumed.optimizer.load_state_dict(restored["optimizer"])
    ada_step(resumed, shapes, 2, mesh)
    out["resumed3"] = ada_whole(resumed, mesh)
    return out


def adafactor_job(rank: int, directory: str) -> dict:
    """adafactor on (1, 2) over ranks 2-3 while rank 0 runs one process,
    then on (2, 2); each run's results from its first rank."""
    import os
    pair = create_mesh(MeshConfig(1, 2), "cpu", ranks=MESH_RANKS[(1, 2)])
    full = create_mesh(MeshConfig(2, 2), "cpu")
    out = {}
    if pair is not None:
        res = adafactor_run(pair, os.path.join(directory, "pair"))
        if rank == MESH_RANKS[(1, 2)][0]:
            out[(1, 2)] = res
    if rank == 0:
        out[(1, 1)] = adafactor_run(ONE, os.path.join(directory, "one"))
    res = adafactor_run(full, os.path.join(directory, "full"))
    if rank == 0:
        out[(2, 2)] = res
    return out


# -- tests/test_torch_ablation_ranks.py --------------------------------------
def recording_writes(writes: list):
    """Patch the ways the ablation study writes files (``Path.write_text``,
    ``open`` for writing, ``csv`` through it, ``torch.save``) to append
    each path written; returns a function that undoes the patches."""
    import builtins
    import pathlib
    write_text, open_, save = (pathlib.Path.write_text, builtins.open,
                               torch.save)

    def patched_write_text(self, *args, **kwargs):
        writes.append(str(self))
        return write_text(self, *args, **kwargs)

    def patched_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax"):
            writes.append(str(file))
        return open_(file, mode, *args, **kwargs)

    def patched_save(obj, f, *args, **kwargs):
        writes.append(str(f))
        return save(obj, f, *args, **kwargs)
    pathlib.Path.write_text = patched_write_text
    builtins.open = patched_open
    torch.save = patched_save

    def undo():
        pathlib.Path.write_text = write_text
        builtins.open = open_
        torch.save = save
    return undo


def study_in_f32_without_dropout():
    """The ablation CLI's models in f32 (the forced-bf16 experts and
    fusions too) with every dropout at 0 (the configs' and the
    experts'), so that a run on 'data' ranks, whose dropout streams
    differ and whose half batches round bf16 products otherwise,
    computes what one process computes; returns a function that undoes
    the patches."""
    from vivqa_tpu_torch.ablation import run_ablation as RA
    from vivqa_tpu_torch.ablation.trainer import AblationTrainer
    from vivqa_tpu_torch.models.fusion import basic
    from vivqa_tpu_torch.models.moe import experts, specialized
    base, build = RA.base_model_config, AblationTrainer._build_model
    forced = (basic, experts, specialized)
    kept = [m._DTYPE for m in forced]

    def base_model_config(*args, **kwargs):
        cfg = base(*args, **kwargs)
        return cfg.replace(
            dtype="float32", visual=cfg.visual.replace(dtype="float32"),
            text=cfg.text.replace(dropout=0.0, dtype="float32"),
            fusion=cfg.fusion.replace(dropout=0.0),
            head=cfg.head.replace(dropout=0.0))

    def build_model(self, model_cfg):
        model = build(self, model_cfg)
        for m in model.modules():
            for attr in ("dropout", "dropout_rate"):
                if isinstance(getattr(m, attr, None), float):
                    setattr(m, attr, 0.0)
            if getattr(m, "dtype", None) == torch.bfloat16:
                m.dtype = torch.float32
        return model
    RA.base_model_config = base_model_config
    AblationTrainer._build_model = build_model
    for m in forced:
        m._DTYPE = torch.float32

    def undo():
        RA.base_model_config = base
        AblationTrainer._build_model = build
        for m, dt in zip(forced, kept):
            m._DTYPE = dt
    return undo


def ablation_runs(argv: list) -> dict:
    """``run_ablation.main``: the study (its results and the files each
    run wrote), the same study again (the experiments it ran), then
    ``--report-only``. Every rank's own record."""
    import dataclasses
    from vivqa_tpu_torch.ablation import run_ablation as RA
    from vivqa_tpu_torch.ablation.trainer import AblationTrainer
    out = {}
    writes: list = []
    undos = [study_in_f32_without_dropout(), recording_writes(writes)]
    run_experiment = AblationTrainer.run_experiment
    try:
        out["results"] = [dataclasses.asdict(r) for r in RA.main(argv)]
        out["writes"] = list(writes)
        ran = []
        AblationTrainer.run_experiment = \
            lambda self, e: ran.append(e.experiment_id) or run_experiment(
                self, e)
        del writes[:]
        again = RA.main(argv)
        out["resumed"] = sorted(r.experiment_id for r in again)
        out["resume_ran"] = ran
        del writes[:]
        out["report_only"] = RA.main(argv + ["--report-only"])
        out["report_writes"] = list(writes)
    finally:
        AblationTrainer.run_experiment = run_experiment
        for undo in undos:
            undo()
    return out


def ablation_job(rank: int, argv: list) -> dict:
    return ablation_runs(argv)
