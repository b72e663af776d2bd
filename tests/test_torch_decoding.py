"""The port's decoding (``vivqa_tpu_torch/models/decoding.py``) against the
JAX package's: greedy and beam generate token-identical on the tiny f32
model, the decode loops on fixed logit tables, early exit against the
fixed loop, top-k/top-p filtering, sampling by its statistics, the beam
cache gather, top-k ties and the beam tiling."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import LA, gen_inputs, gen_model_pair, t
from vivqa_tpu.models import decoding as jdec
from vivqa_tpu_torch.models import decoding as pdec
from vivqa_tpu_torch.models.decoder import DecodeCache

torch.set_num_threads(1)

# On the tiny model's inputs (gen_inputs(7)) token 16 is the runner-up at
# most steps, so with it as EOS beams finish at different steps; 49 is
# never emitted, so no beam finishes and the best live beam is returned.
FREQUENT_EOS, RARE_EOS = 16, 49

GENERATE_CASES = {  # id: (strategy, EOS, length penalty alpha)
    "greedy": ("greedy", FREQUENT_EOS, 0.6),
    "greedy_no_eos": ("greedy", RARE_EOS, 0.6),
    "beam": ("beam", FREQUENT_EOS, 0.6),
    "beam_neg_alpha": ("beam", FREQUENT_EOS, -0.5),
    "beam_no_eos": ("beam", RARE_EOS, 0.6),
}


def decode_config(mod, strategy, eos, alpha, early_exit=True):
    return mod.DecodeConfig(max_length=LA, strategy=strategy, num_beams=4,
                            bos_token_id=0, eos_token_id=eos, pad_token_id=1,
                            length_penalty=alpha, early_exit=early_exit)


@pytest.fixture(scope="module")
def tiny():
    jm, params, port = gen_model_pair()
    px, q, qmask, _, _ = gen_inputs(7)
    return jm, params, port, (px, q, qmask)


@pytest.fixture(scope="module")
def jax_generated(tiny):
    """JAX generate, jitted once per case."""
    jm, params, _, (px, q, qmask) = tiny
    out = {}
    for case, args in GENERATE_CASES.items():
        gen = jax.jit(jdec.build_generate_fn(jm, decode_config(jdec, *args)))
        seqs, scores = gen(params, px, q, qmask)
        out[case] = np.asarray(seqs), np.asarray(scores)
    return out


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_token_identical_to_jax(tiny, jax_generated, case):
    _, _, port, (px, q, qmask) = tiny
    want_seqs, want_scores = jax_generated[case]
    gen = pdec.build_generate_fn(port, decode_config(pdec,
                                                     *GENERATE_CASES[case]))
    seqs, scores = gen(t(px), t(q), t(qmask))
    assert seqs.shape == (3, LA) and scores.dtype == torch.float32
    np.testing.assert_array_equal(seqs.numpy(), want_seqs)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=1e-5,
                               atol=1e-5)


def test_generate_cases_reach_their_branches(jax_generated):
    """The cases above do what their ids say: EOS reached in some rows
    only, or nowhere."""
    greedy = jax_generated["greedy"][0]
    assert (greedy == FREQUENT_EOS).any(axis=1).sum() in (1, 2)
    assert not (jax_generated["beam_no_eos"][0] == RARE_EOS).any()
    assert (jax_generated["beam"][0] == FREQUENT_EOS).any()


@pytest.mark.parametrize("case", ["greedy", "beam", "beam_neg_alpha"])
def test_early_exit_matches_fixed_loop_on_model(tiny, case):
    _, _, port, (px, q, qmask) = tiny
    outs = [pdec.build_generate_fn(port, decode_config(
        pdec, *GENERATE_CASES[case], early_exit=ee))(t(px), t(q), t(qmask))
        for ee in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# -- the loops on fixed logit tables (tests/test_decoding.py's) ---------------
def _jax_table_fn(table):
    table = jnp.asarray(table)

    def apply_fn(cache, tokens):
        logits = jax.lax.dynamic_index_in_dim(
            jnp.swapaxes(table, 0, 1), cache, axis=0, keepdims=False)
        return logits, cache + 1
    return apply_fn


def _port_table_fn(table):
    table = torch.from_numpy(table)

    def apply_fn(cache, tokens):
        return table[:, cache.index], dataclasses.replace(
            cache, index=cache.index + 1)
    return apply_fn


def _table_cache(rows: int) -> DecodeCache:
    """A cache for a table's apply_fn: the loops take their device from
    it, and beam search gathers its self_kv."""
    kv = torch.arange(rows, dtype=torch.float32).view(1, 1, rows, 1, 1, 1)
    return DecodeCache(kv.expand(2, 2, rows, 3, 1, 2).clone(),
                       torch.zeros(2, 2, rows, 1, 1, 2), None,
                       torch.ones(3, 3, dtype=torch.bool).tril())


def _greedy_table():
    V, B, L = 8, 3, 10
    table = np.random.RandomState(0).randn(B, L, V).astype(np.float32)
    table[:, :, 2] -= 100.0          # EOS only where forced
    table[0, 1, 2] += 200.0          # row 0 ends at step 1
    table[1, 3, 2] += 200.0          # row 1 at step 3
    table[2, 5, 2] += 200.0          # row 2 at step 5
    return table


@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_loop_matches_jax_on_table(early_exit):
    table = _greedy_table()
    B, L = table.shape[:2]
    cfgs = [mod.DecodeConfig(max_length=L, strategy="greedy",
                             bos_token_id=0, eos_token_id=2, pad_token_id=1,
                             early_exit=early_exit) for mod in (jdec, pdec)]
    want = jax.jit(lambda c: jdec.autoregressive_decode(
        _jax_table_fn(table), c, B, cfgs[0]))(jnp.int32(0))
    got = pdec.autoregressive_decode(_port_table_fn(table), _table_cache(B),
                                     B, cfgs[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    seqs = got[0].numpy()
    assert (seqs[0, 1], seqs[1, 3], seqs[2, 5]) == (2, 2, 2)
    assert (seqs[0, 2:] == 1).all()


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.6, -0.5])
def test_beam_loop_matches_jax_on_table(alpha, early_exit):
    V, B, K, L = 8, 2, 3, 10
    table = np.random.RandomState(1).randn(B * K, L, V).astype(np.float32)
    table[:, 2:, 2] += 6.0           # EOS likely from step 2 on
    cfgs = [mod.DecodeConfig(max_length=L, strategy="beam", num_beams=K,
                             bos_token_id=0, eos_token_id=2, pad_token_id=1,
                             length_penalty=alpha, early_exit=early_exit)
            for mod in (jdec, pdec)]
    want = jax.jit(lambda c: jdec.beam_search(_jax_table_fn(table), c, B,
                                              cfgs[0]))(jnp.int32(0))
    got = pdec.beam_search(_port_table_fn(table), _table_cache(B * K), B,
                           cfgs[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    assert (got[0].numpy() == 2).any()


def test_early_exit_stops_early_on_table():
    """With every row finished at step 5, the early loop runs 6 steps."""
    table = _greedy_table()
    B, L = table.shape[:2]
    calls = []

    def apply_fn(cache, tokens):
        calls.append(cache.index)
        return _port_table_fn(table)(cache, tokens)
    pdec.autoregressive_decode(apply_fn, _table_cache(B), B,
                               pdec.DecodeConfig(max_length=L, eos_token_id=2,
                                                 pad_token_id=1))
    assert calls == list(range(6))


# -- filtering and sampling ---------------------------------------------------
@pytest.mark.parametrize("strategy,knob", [("top_k", 5), ("top_k", 64),
                                           ("top_p", 0.9), ("top_p", 0.3)])
def test_filtering_keeps_the_same_tokens_as_jax(monkeypatch, strategy, knob):
    """JAX's _sample_logits with jax.random.categorical replaced by the
    identity returns its filtered logits."""
    logits = np.random.RandomState(3).randn(4, 64).astype(np.float32) * 2
    kw = {"top_k": knob} if strategy == "top_k" else {"top_p": knob}
    cfgs = [mod.DecodeConfig(strategy=strategy, temperature=0.7, **kw)
            for mod in (jdec, pdec)]
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, x, axis=-1: x)
    want = np.asarray(jdec._sample_logits(jnp.asarray(logits),
                                          jax.random.PRNGKey(0), cfgs[0]))
    got = pdec.filter_logits(torch.from_numpy(logits), cfgs[1]).numpy()
    kept = want > jdec.NEG_INF / 2
    np.testing.assert_array_equal(got > pdec.NEG_INF / 2, kept)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if strategy == "top_k":
        assert (kept.sum(-1) == min(knob, 64)).all()
    else:
        assert (kept.sum(-1) < 64).all() and (kept.sum(-1) >= 1).all()


@pytest.mark.parametrize("strategy", ["top_k", "top_p"])
def test_sampling_follows_filtered_softmax(strategy):
    """Draws under a torch.Generator repeat with its seed, never leave the
    filtered set, and match softmax(filtered logits) in frequency (20,000
    draws: 3 standard errors of a share <= 0.5 is < 0.011)."""
    logits = torch.from_numpy(
        np.random.RandomState(4).randn(1, 10).astype(np.float32))
    cfg = pdec.DecodeConfig(strategy=strategy, top_k=4, top_p=0.8)
    rows = logits.expand(20000, 10)
    draws = [pdec._sample_logits(rows, torch.Generator().manual_seed(5), cfg)
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    filtered = pdec.filter_logits(logits, cfg)[0]
    probs = torch.softmax(filtered, -1)
    freq = torch.bincount(draws[0], minlength=10).float() / len(rows)
    assert (freq[filtered <= pdec.NEG_INF / 2] == 0).all()
    assert float((freq - probs).abs().max()) < 0.011


def test_sampled_generate_is_reproducible(tiny):
    _, _, port, (px, q, qmask) = tiny
    gen = pdec.build_generate_fn(port, decode_config(pdec, "top_k", 49, 0.6))
    a = gen(t(px), t(q), t(qmask), generator=torch.Generator().manual_seed(3))
    b = gen(t(px), t(q), t(qmask), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- beams -------------------------------------------------------------------
def test_gather_beams_matches_jax_and_skips_cross_kv():
    B, K = 2, 3
    rs = np.random.RandomState(6)
    self_kv = rs.randn(2, 2, B * K, 4, 2, 3).astype(np.float32)
    cross_kv = rs.randn(2, 2, B * K, 5, 2, 3).astype(np.float32)
    beam_idx = np.array([[2, 2, 0], [1, 0, 1]])
    tree = {"layers_0": {
        "self_attn": {"cached_key": self_kv[0, 0],
                      "cached_value": self_kv[0, 1],
                      "cache_index": np.int32(2)},
        "cross_attn": {"cached_ckey": cross_kv[0, 0],
                       "cached_cvalue": cross_kv[0, 1]}}}
    want = jdec._gather_beams(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(beam_idx), B, K)["layers_0"]
    cache = DecodeCache(torch.from_numpy(self_kv),
                        torch.from_numpy(cross_kv), None,
                        torch.ones(4, 4, dtype=torch.bool).tril(), 2)
    got = pdec._gather_beams(cache, torch.from_numpy(beam_idx), B, K)
    np.testing.assert_array_equal(got.self_kv[0, 0].numpy(),
                                  want["self_attn"]["cached_key"])
    np.testing.assert_array_equal(got.self_kv[0, 1].numpy(),
                                  want["self_attn"]["cached_value"])
    np.testing.assert_array_equal(want["cross_attn"]["cached_ckey"],
                                  cross_kv[0, 0])
    assert got.cross_kv is cache.cross_kv and got.index == 2


def test_top_k_ties_go_to_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 4, 6):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = pdec.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_tile_for_beams_interleaves_like_jnp_repeat():
    x = np.arange(24, dtype=np.float32).reshape(3, 4, 2)
    want = jdec.tile_for_beams({"m": jnp.asarray(x)}, 4)["m"]
    np.testing.assert_array_equal(
        pdec.tile_for_beams(torch.from_numpy(x), 4).numpy(), want)


def test_length_penalty_matches_jax():
    for length in (1, 5, 32):
        for alpha in (0.0, 0.6, -0.5):
            assert pdec._length_penalty(length, alpha) == pytest.approx(
                float(jdec._length_penalty(length, alpha)), rel=1e-6)
