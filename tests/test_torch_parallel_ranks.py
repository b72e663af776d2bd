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
