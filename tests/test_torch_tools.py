"""The port's step-budget tools (``vivqa_tpu_torch/tools/``) against the
JAX tools they port (``tools/profile_towers.py``,
``tools/profile_components.py``, ``tools/bench_input_pipeline.py``): each
tower's loss and gradient norm from the JAX modules the JAX tool builds,
on the same weights, at tiny sizes in eval mode; the components' loss
against JAX's cross-entropy + 0.01 x aux; every mode and tower runs on
the CPU and prints its JSON line; without a card each tool raises."""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, as_f32, assert_close,
                                assert_close_bf16, forced_bf16_as_f32,
                                jax_params, small_cls_config)
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import load_flax_params
from vivqa_tpu_torch.tools import (bench_input_pipeline, profile_components,
                                   profile_towers)
from vivqa_tpu_torch.utils import profiling

B = 2
SIZES = profile_towers.TowerSizes(
    image_size=16, patch_size=8, hidden=32, layers=1, heads=2, d_ff=64,
    vocab=100, text_len=8, fusion_hidden=32, fusion_heads=2,
    fusion_layers=1, experts=4, expert_hidden=32, answers=10)
CPU = torch.device("cpu")


def _jax_tower(name: str, inputs: tuple, nomask: bool = False):
    """(params, loss(params)) of the JAX tool's tower ``name``
    (tools/profile_towers.py:54-169) at ``SIZES`` in f32 and eval mode,
    on the port tower's own inputs."""
    import flax.linen as nn
    from vivqa_tpu.models.config import (AnswerHeadConfig, FusionConfig,
                                         TextEncoderConfig,
                                         VisualEncoderConfig)
    s = SIZES
    x = [jnp.asarray(a.numpy()) for a in inputs]
    if name == "visual":
        from vivqa_tpu.models.encoders import create_visual_encoder
        enc = create_visual_encoder(VisualEncoderConfig(
            backbone="clip", image_size=s.image_size,
            patch_size=s.patch_size, hidden_dim=s.hidden,
            num_layers=s.layers, num_heads=s.heads, dtype="float32"))
        params = jax_params(enc, x[0])

        def loss(p):
            out = enc.apply({"params": p}, x[0], deterministic=True)
            return (out["pooled"].astype(jnp.float32) ** 2).mean()
    elif name == "text":
        from vivqa_tpu.models.encoders import create_text_encoder
        enc = create_text_encoder(TextEncoderConfig(
            backbone="phobert", vocab_size=s.vocab, hidden_dim=s.hidden,
            num_layers=s.layers, num_heads=s.heads, max_length=s.text_len,
            dtype="float32"))
        mask = None if nomask else jnp.ones((B, s.text_len), jnp.int32)
        params = jax_params(enc, x[0])

        def loss(p):
            out = enc.apply({"params": p}, x[0], mask, deterministic=True)
            return (out["pooled"].astype(jnp.float32) ** 2).mean()
    elif name == "embed":
        from vivqa_tpu.ops.embedding import MatmulGradEmbed
        emb = MatmulGradEmbed(s.vocab, s.hidden)
        params = jax_params(emb, x[0])

        def loss(p):
            return (emb.apply({"params": p}, x[0]).astype(jnp.float32)
                    ** 2).mean()
    elif name == "trunk":
        from vivqa_tpu.models.layers import EncoderLayer, make_attention_mask

        class Trunk(nn.Module):
            @nn.compact
            def __call__(self, h, mask=None, *, deterministic=True):
                for i in range(s.layers):
                    h = EncoderLayer(num_heads=s.heads, d_ff=s.d_ff,
                                     dropout=0.1, dtype=jnp.float32,
                                     name=f"l{i}")(
                        h, mask=mask, deterministic=deterministic)
                return h
        mod = Trunk()
        pad = jnp.ones((B, s.text_len), jnp.int32)
        mask = None if nomask else make_attention_mask(pad, pad)
        params = jax_params(mod, x[0], mask)

        def loss(p):
            out = mod.apply({"params": p}, x[0], mask, deterministic=True)
            return (out.astype(jnp.float32) ** 2).mean()
    else:
        from vivqa_tpu.models.fusion import create_fusion
        from vivqa_tpu.models.heads import AnswerHead
        from vivqa_tpu.models.moe import (ExpertConfig, MoEConfig,
                                          RouterConfig, create_moe_layer)

        class Fuse(nn.Module):
            @nn.compact
            def __call__(self, visual, text, *, deterministic=True):
                fusion = create_fusion(FusionConfig(
                    fusion_type="mcan", hidden_dim=s.fusion_hidden,
                    num_heads=s.fusion_heads, num_layers=s.fusion_layers))
                moe = create_moe_layer(MoEConfig(
                    num_experts=s.experts, input_dim=s.fusion_hidden,
                    expert=ExpertConfig(hidden_dim=s.expert_hidden),
                    router=RouterConfig(router_type="noisy_topk", top_k=2)))
                head = AnswerHead(AnswerHeadConfig(), num_answers=s.answers)
                out = fusion(visual, text, deterministic=deterministic)
                tokens, aux = moe(out["tokens"], deterministic=deterministic)
                logits = head(tokens.mean(axis=1),
                              deterministic=deterministic)
                return logits, aux["aux_loss"]
        mod = Fuse()
        visual = {"tokens": x[0], "pooled": x[1]}
        text = {"tokens": x[2], "pooled": x[3], "mask": x[4]}
        key = jax.random.PRNGKey(0)
        params = jax_params(mod, visual, text, jit=True,
                            rngs={"params": key, "router": key})

        def loss(p):
            logits, aux = mod.apply({"params": p}, visual, text,
                                    deterministic=True)
            return (logits.astype(jnp.float32) ** 2).mean() + 0.01 * aux
    return params, loss


def _norm(arrays) -> np.float32:
    return np.float32(math.sqrt(sum(
        float(np.square(np.asarray(a, np.float64)).sum()) for a in arrays)))


@pytest.mark.parametrize("name", profile_towers.TOWERS)
def test_tower_loss_and_gradient_match_jax(name):
    """``build_tower``'s loss and its gradient norm equal the JAX tool's
    on the same weights and inputs: f32 to 1e-5, and the fusion (MCAN and
    the head compute in bf16 in both packages) to a bf16 rounding. The
    token tables' gradients are held apart, to a bf16 rounding: JAX's
    embedding backward rounds its incoming gradient to bf16 even in an
    f32 model."""
    from vivqa_tpu_torch.models.from_jax import flatten_params, flax_paths
    module, inputs, loss = profile_towers.build_tower(
        name, B, CPU, dtype="float32", deterministic=True, sizes=SIZES)
    params, jloss = _jax_tower(name, inputs)
    load_flax_params(module, params)
    got = loss(*inputs)
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(got, [p for _, p in
                                      module.named_parameters()],
                                allow_unused=True)
    paths = flax_paths(module)
    port = {paths[n]: (np.zeros(tuple(p.shape)) if g is None
                       else g.double().numpy())
            for (n, p), g in zip(module.named_parameters(), grads)}
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    jflat = flatten_params(jax.device_get(jgrads))
    assert set(port) == set(jflat) and len(names) == len(port)
    tables = {k for k in jflat if k.endswith("embedding")}
    rest = sorted(set(jflat) - tables)
    close = assert_close_bf16 if name == "fusion" else (
        lambda a, b, msg: assert_close(a, b, **F32_TOL, msg=msg))
    close(got, want, msg="loss")
    close(_norm(port[k] for k in rest), _norm(jflat[k] for k in rest),
          msg="grad norm")
    if tables:
        assert_close_bf16(_norm(port[k] for k in tables),
                          _norm(jflat[k] for k in tables),
                          msg="token table's grad norm")


def test_components_loss_is_jax_cross_entropy_plus_aux():
    """profile_components' loss (tools/profile_components.py:100-106):
    cross-entropy + 0.01 x the router aux loss, on the same weights as
    the JAX model's, both in f32 (the forced-bf16 modules too)."""
    from vivqa_tpu.models import config as JC
    from vivqa_tpu.models.vqa_model import VietnameseVQAModel as JModel
    from vivqa_tpu.train import cross_entropy_loss
    jcfg = small_cls_config(JC).replace(moe=JC.MoEModelConfig(
        use_moe=True, num_experts=4, top_k=2, expert_hidden_dim=32))
    pcfg = small_cls_config(PC).replace(moe=PC.MoEModelConfig(
        use_moe=True, num_experts=4, top_k=2, expert_hidden_dim=32))
    rs = np.random.RandomState(0)
    px = rs.rand(B, 16, 16, 3).astype(np.float32)
    ids = rs.randint(0, 49, (B, 8)).astype(np.int32)
    mask = np.ones((B, 8), np.int32)
    labels = rs.randint(0, 10, (B,)).astype(np.int32)
    with forced_bf16_as_f32():
        jm = JModel(jcfg)
        key = jax.random.PRNGKey(0)
        params = jax_params(jm, px, ids, mask,
                            rngs={"params": key, "router": key})
        out = jm.apply({"params": params}, px, ids, mask, deterministic=True)
        want = cross_entropy_loss(out["logits"], labels) \
            + 0.01 * out["aux_loss"]
    model = as_f32(load_flax_params(
        profile_components.build_model(pcfg, CPU), params)).eval()
    batch = {"pixel_values": torch.from_numpy(px),
             "input_ids": torch.from_numpy(ids).long(),
             "attention_mask": torch.from_numpy(mask).long(),
             "labels": torch.from_numpy(labels).long()}
    got, metrics = profile_components.loss_fn()(model, batch,
                                                torch.Generator())
    assert_close(got, want, **F32_TOL)
    assert_close(got, metrics["ce"] + 0.01 * metrics["aux_loss"], **F32_TOL)


def _tiny_flagship():
    return small_cls_config(PC, dropout=0.1).replace(
        moe=PC.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                              expert_hidden_dim=32))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", profile_components.MODES)
def test_components_mode_runs_on_the_cpu(mode, capsys):
    line = profile_components.main(["--batch", "2", "--steps", "2",
                                    "--only", mode, "--device", "cpu"],
                                   cfg=_tiny_flagship())
    printed = _last_json(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(line))
    assert printed["device"] == "cpu" and printed["card"] is None
    r = printed["modes"][mode]
    assert set(printed["modes"]) == {mode}
    # no profiled window on the CPU: a host clock is not a device time
    assert r["wall_ms"] > 0 and r["busy_ms"] is None \
        and r["idle_share"] is None and r["profiled_window_ms"] is None
    # the plain path on the CPU: no kernel launches
    assert set(r["launches_per_call"].values()) == {0.0}


class _Probe:
    """A ``within`` that notes how many calls had run when it was entered
    and when it was left."""

    def __init__(self, calls: list):
        self.calls, self.at = calls, []

    def __enter__(self):
        self.at.append(len(self.calls))

    def __exit__(self, *exc):
        self.at.append(len(self.calls))


def test_timers_enter_within_around_the_timed_calls_alone():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2
    probe = _Probe(calls)
    profiling.time_chained(fn, (torch.ones(3),), steps=4, within=probe)
    assert probe.at == [1, 5]           # after the warm-up call, around 4

    def step(state, batch):
        calls.append(1)
        return state, {}
    calls.clear()
    probe = _Probe(calls)
    times = profiling.time_train_steps(step, None, {"x": torch.ones(1)},
                                       steps=3, within=probe)
    assert probe.at == [0, 3] and len(times.host_ms) == 3


def test_profiled_window_times_under_a_kernel_clock():
    seen = []

    def timer(within):
        with within:
            seen.append(within)
        return 2.5
    window, busy = profiling.profiled_window(timer, calls=4)
    assert window == 2.5
    assert all(isinstance(w, profiling.KernelClock) for w in seen)
    if not torch.cuda.is_available():
        # no kernel recorded: every try is made, and no busy time made up
        assert busy is None and len(seen) == 3


def test_components_implied_costs(capsys):
    line = profile_components.main(["--batch", "2", "--steps", "1",
                                    "--device", "cpu"], cfg=_tiny_flagship())
    out = capsys.readouterr().out
    for label in ("full step", "forward only", "fwd (eval mode)",
                  "fwd + bwd", "optimizer only", "implied backward",
                  "implied opt+update", "dropout/router-noise cost"):
        assert label in out
    m = line["modes"]
    assert line["implied_ms"]["backward"] == pytest.approx(
        m["fwd_bwd"]["wall_ms"] - m["fwd"]["wall_ms"])


@pytest.mark.parametrize("tower", profile_towers.TOWERS)
def test_tower_runs_on_the_cpu(tower, capsys):
    line = profile_towers.main(["--tower", tower, "--batch", "2",
                                "--steps", "2", "--device", "cpu"],
                               sizes=SIZES)
    out = capsys.readouterr().out
    assert "forward :" in out and "bwd/fwd ratio" in out
    r = _last_json(out)["towers"][tower]
    assert r == json.loads(json.dumps(line["towers"][tower]))
    assert r["forward"]["wall_ms"] > 0 and r["fwd_bwd"]["wall_ms"] > 0
    assert r["bwd_fwd_ratio"] == pytest.approx(
        (r["fwd_bwd"]["wall_ms"] - r["forward"]["wall_ms"])
        / r["forward"]["wall_ms"])


def test_input_pipeline_small_corpus(capsys):
    line = bench_input_pipeline.main(["--n", "8", "--size", "32",
                                      "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "train: PIL" in out and "eval: PIL" in out
    for mode in ("train", "eval"):
        r = line["modes"][mode]
        assert r["pil_images_per_s"] > 0
        if line["native_available"]:
            assert r["native_images_per_s"] > 0
        else:
            assert r["native_images_per_s"] is None


def test_input_corpus_is_the_jax_tools():
    """The same seeded 640x480 JPEG corpus as tools/bench_input_pipeline.py
    draws (``RandomState(0)``)."""
    import importlib.util
    import tempfile
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "jax_bench_input", Path(__file__).resolve().parents[1] / "tools" /
        "bench_input_pipeline.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        pa = bench_input_pipeline.make_corpus(Path(a), 2, hw=(48, 64))
        pb = jtool.make_corpus(Path(b), 2, hw=(48, 64))
        for x, y in zip(pa, pb):
            assert Path(x).read_bytes() == Path(y).read_bytes()


@pytest.mark.parametrize("tool,argv", [
    (profile_components, []),
    (profile_towers, ["--tower", "embed"]),
    (bench_input_pipeline, ["--n", "2"])])
def test_tool_without_a_card_raises(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)
