"""adafactor on the ('data', 'model') mesh against one process and optax,
on the CPU.

``Optimizer._adafactor`` factors by the whole flax leaf's dimensions:
where 'model' splits the dimension a statistic averages over, the
slice's sums are summed over 'model' and divided by the whole length;
where the statistic keeps the split dimension it keeps its slice. The
ranks (tests/test_torch_parallel_ranks.py: ``adafactor_job``) drive the
optimizer over ``AdaNet``'s leaves, one of each case, with the same
seeded gradients on (1, 2), (2, 2) and one process: three updates, and
a resume on the same mesh from the whole state saved after two. f32:
parameters and statistics to 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_parallel_ranks as R
from vivqa_tpu.train import optimizers as JO
from vivqa_tpu_torch.models import from_jax as FJ
from vivqa_tpu_torch.parallel.launch import start_ranks
from vivqa_tpu_torch.train.optimizers import factored_dims

torch.set_num_threads(1)
TOL = 1e-5
SHAPES = ((1, 2), (2, 2))


def _tree(model, tensors: dict) -> dict:
    """{torch name: tensor} -> the nested flax tree (numpy)."""
    layouts, paths, out = FJ.flax_layouts(model), FJ.flax_paths(model), {}
    for name, t in tensors.items():
        node = out
        *heads, leaf = paths[name].split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[leaf] = FJ.to_flax_view(layouts[name], torch.as_tensor(t)
                                     ).numpy().copy()
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The ranks' runs (started first) and optax's three updates."""
    ranks = start_ranks(R.adafactor_job, 4,
                        str(tmp_path_factory.mktemp("adafactor")))
    model = R.ada_model()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = jax.tree.map(jnp.asarray, _tree(model, dict(
        (n, p.detach()) for n, p in model.named_parameters())))
    o = R.ADA_OPT
    tx = JO.create_optimizer(
        JO.OptimizerConfig(name=o.name, learning_rate=o.learning_rate,
                           weight_decay=o.weight_decay,
                           grad_clip_norm=o.grad_clip_norm),
        None, params=params)
    state = tx.init(params)
    for step in range(3):
        grads = jax.tree.map(jnp.asarray, _tree(model, R.ada_grads(shapes,
                                                                   step)))
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
    results = {k: v for r in ranks.results() for k, v in r.items()}
    return model, FJ.flatten_params(jax.device_get(params)), \
        FJ.optax_state_arrays(jax.device_get(state)), results


def _close(got: dict, want: dict, msg: str):
    assert sorted(got) == sorted(want), msg
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"{msg} {k}")


def test_the_leaves_cover_every_case(setup):
    """AdaNet holds a split leaf whose split dimension one statistic
    averages over (the MLP kernels; the knowledge projection, at its
    second largest dimension), split leaves whose statistics both keep
    the split (attention, experts), and unfactored leaves, split (the
    experts' biases) or not; on (1, 2) each statistic is whole or halved
    accordingly."""
    model, _, _, res = setup
    layouts = FJ.flax_layouts(model)
    local = res[(1, 2)]["local_shapes"]
    whole = res[(1, 1)]["local_shapes"]
    halved = {f: {n for n in whole[f] if local[f][n] != whole[f][n]}
              for f in ("v_row", "v_col")}
    assert "mlp.wi.weight" in halved["v_col"] - halved["v_row"]
    assert "mlp.wo.weight" in halved["v_col"] - halved["v_row"]
    assert "knowledge_attn.k_proj.weight" in \
        halved["v_row"] - halved["v_col"]
    for n in ("self_attn.query.weight", "self_attn.out.weight",
              "moe.experts_w_in", "moe.experts_w_out"):
        assert n in halved["v_row"] & halved["v_col"], n
    assert factored_dims(layouts["ln.weight"][2]) is None
    # an unfactored split leaf: v is the parameter's slice
    assert factored_dims(layouts["moe.experts_bias_in"][2]) is None
    assert local["v"]["moe.experts_bias_in"] == (1, 256)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_adafactor_on_the_mesh_matches_one_process(setup, shape):
    """Three updates: each grad norm, the parameters and every statistic
    (gathered whole) equal to one process's within 1e-5."""
    _, _, _, res = setup
    got, one = res[shape], res[(1, 1)]
    np.testing.assert_allclose(got["norms"], one["norms"], rtol=TOL)
    for when in ("after2", "after3"):
        _close(got[when]["params"], one[when]["params"], f"{shape} {when}")
        for field, ts in one[when]["state"].items():
            _close(got[when]["state"][field], ts, f"{shape} {when} {field}")


@pytest.mark.parametrize("shape", ((1, 1),) + SHAPES, ids=str)
def test_adafactor_matches_optax(setup, shape):
    """The parameters after three updates, and the factored statistics,
    are optax.adafactor's as the JAX package's ``create_optimizer``
    builds it (no clipping of the update, no parameter scale)."""
    model, want, want_state, res = setup
    got = res[shape]["after3"]
    paths = FJ.flax_paths(model)
    _close(FJ.flatten_params(_tree(model, got["params"])), want,
           f"{shape} vs optax")
    for field in ("v_row", "v_col"):
        mine = {paths[n]: v for n, v in got["state"][field].items()
                if v.size > 1}
        theirs = {p: v for p, v in want_state[field].items()
                  if np.size(v) > 1}
        _close(mine, theirs, f"{shape} {field} vs optax")


@pytest.mark.parametrize("shape", ((1, 1),) + SHAPES, ids=str)
def test_adafactor_resumes_from_the_whole_state(setup, shape):
    """The whole state saved after two updates (the single-card format)
    resumes on the same mesh, each rank taking its slices of the
    factored statistics: the third update equals the uninterrupted
    run's."""
    _, _, _, res = setup
    got = res[shape]
    _close(got["resumed3"]["params"], got["after3"]["params"],
           f"{shape} resumed")
    for field, ts in got["after3"]["state"].items():
        _close(got["resumed3"]["state"][field], ts, f"{shape} {field}")
