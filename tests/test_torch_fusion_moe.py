"""Parity of the port's MCAN fusion, routers and dense MoE layer with the
JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, assert_close,
                                assert_close_bf16, jax_params,
                                padding_mask, port_with)
from vivqa_tpu.models import config as JC
from vivqa_tpu.models.fusion.mcan import AttFlat as JAttFlat
from vivqa_tpu.models.fusion.mcan import MCANFusion as JMCAN
from vivqa_tpu.models.moe import config as JMC
from vivqa_tpu.models.moe import routers as JR
from vivqa_tpu.models.moe.layer import MOELayer as JMOE
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.fusion import create_fusion
from vivqa_tpu_torch.models.fusion.mcan import AttFlat
from vivqa_tpu_torch.models.moe import config as PMC
from vivqa_tpu_torch.models.moe import routers as PR
from vivqa_tpu_torch.models.moe.layer import MOELayer, create_moe_layer

torch.set_num_threads(1)

def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# MCAN and AttFlat compute in bf16 whatever the config says
# (vivqa_tpu/models/fusion/mcan.py:29,50): held with assert_close_bf16


def test_att_flat_masked():
    x = _rand((2, 8, 32), 0)
    mask = padding_mask((8, 3), 8)
    jm = JAttFlat(32, glimpses=2, mlp_dim=16)
    params = jax_params(jm, jnp.asarray(x, jnp.bfloat16), mask)
    port = port_with(AttFlat(32, 32, glimpses=2, mlp_dim=16), params)
    got = port(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))
    want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16), mask)
    assert_close_bf16(got, want)


def test_mcan_fusion():
    cfg = dict(fusion_type="mcan", hidden_dim=32, num_heads=2, num_layers=2,
               mcan_flat_mlp_dim=24)
    visual = {"tokens": _rand((2, 4, 24), 1)}
    t_mask = padding_mask((8, 5), 8)
    text = {"tokens": _rand((2, 8, 40), 2), "mask": t_mask}
    jm = JMCAN(JC.FusionConfig(**cfg))
    params = jax_params(jm, visual, text)
    port = port_with(create_fusion(PC.FusionConfig(**cfg), 24, 40), params)
    got = port({"tokens": torch.from_numpy(visual["tokens"])},
               {"tokens": torch.from_numpy(text["tokens"]),
                "mask": torch.from_numpy(t_mask)})
    want = jm.apply({"params": params}, visual, text)
    for key in ("pooled", "tokens"):
        assert got[key].dtype == torch.bfloat16
        assert_close_bf16(got[key], want[key], msg=key)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


def test_unported_fusion_raises():
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        create_fusion(PC.FusionConfig(fusion_type="qformer"), 8, 8)


def test_topk_dense_breaks_ties_toward_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3):
        jw, ja = JR._topk_dense(jnp.asarray(probs), k)
        pw, pa = PR._topk_dense(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


def test_router_losses_and_metrics():
    logits = _rand((2, 5, 4), 3) * 2
    probs = np.array(jax.nn.softmax(logits, -1))
    jw, ja = JR._topk_dense(jnp.asarray(probs), 2)
    pw, pa = PR._topk_dense(torch.from_numpy(probs), 2)
    assert_close(PR.load_balance_loss(torch.from_numpy(probs), pa),
                 JR.load_balance_loss(jnp.asarray(probs), ja), **F32_TOL)
    assert_close(PR.router_z_loss(torch.from_numpy(logits)),
                 JR.router_z_loss(jnp.asarray(logits)), **F32_TOL)
    jm, pm = (JR._router_metrics(jnp.asarray(probs), jw),
              PR._router_metrics(torch.from_numpy(probs), pw))
    for key in jm:
        assert_close(pm[key], jm[key], **F32_TOL, msg=key)


MOE_CASES = [
    dict(dtype="float32", expert_mask=None, z=0.0),
    dict(dtype="float32", expert_mask=(1, 0, 1, 1), z=0.001),
    dict(dtype="bfloat16", expert_mask=None, z=0.0),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_moe_layer(case):
    """Output, aux_loss and router metrics; MOELayer runs in its input's
    dtype, so f32 input is held to f32 tolerance. With bf16 input only the
    f32 router sees the same logits, so aux and metrics stay tight."""
    def cfg(mod):
        return mod.MoEConfig(
            num_experts=4, input_dim=32,
            expert=mod.ExpertConfig(hidden_dim=48),
            router=mod.RouterConfig(top_k=2, z_loss_weight=case["z"]))
    jdt = jnp.float32 if case["dtype"] == "float32" else jnp.bfloat16
    tdt = torch.float32 if case["dtype"] == "float32" else torch.bfloat16
    x = _rand((2, 6, 32), 4)
    em = None if case["expert_mask"] is None else np.asarray(
        case["expert_mask"], np.float32)
    jm = JMOE(cfg(JMC))
    params = jax_params(jm, jnp.asarray(x, jdt), em, noise=0.2)
    port = port_with(MOELayer(cfg(PMC)), params)
    y, aux = port(torch.from_numpy(x).to(tdt),
                  None if em is None else torch.from_numpy(em))
    jy, jaux = jm.apply({"params": params}, jnp.asarray(x, jdt), em)
    assert y.dtype == tdt
    if case["dtype"] == "float32":
        assert_close(y, jy, **F32_TOL)
    else:
        assert_close_bf16(y, jy)
    assert_close(aux["aux_loss"], jaux["aux_loss"], atol=1e-6, rtol=1e-5)
    for key in jaux["metrics"]:
        assert_close(aux["metrics"][key], jaux["metrics"][key], atol=1e-5,
                     rtol=1e-5, msg=key)
    if em is not None:
        assert float(aux["metrics"]["expert_usage"][1]) == 0.0


def test_unported_moe_parts_raise():
    with pytest.raises(NotImplementedError):
        create_moe_layer(PMC.MoEConfig(moe_type="sparse"))
    with pytest.raises(NotImplementedError):
        PR.create_router(PMC.RouterConfig(router_type="soft"), 4, 8)
