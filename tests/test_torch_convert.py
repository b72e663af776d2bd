"""The HF import of the port (``models/hf_files.py``, ``models/convert.py``)
against the JAX package's ``models/convert.py``.

``transformers`` builds each architecture at random (at
``tests/test_convert.py``'s sizes, every parameter and BatchNorm
statistic perturbed by seeded noise so that no bias or scale is
trivially 0 or 1) and saves it with ``save_pretrained`` into a temporary
directory; that is all it does for the port. The port reads the
directory with ``transformers`` blocked (``sys.modules["transformers"]
= None``) and converts it; the JAX converter converts the in-memory HF
model. The two trees are equal leaf for leaf (the BatchNorm fold within
one ulp), the port's encoder with the tree matches the HF model's output
to 3e-3 (``tests/test_convert.py``'s ATOL: flax's LayerNorm eps 1e-6
against HF's 1e-12 or 1e-5) and the JAX encoder's output to 1e-5 in f32.
The loaders, the reader's file forms and the graft's strict errors are
held below; no test reaches the network or the hub.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import F32_TOL, assert_close
from vivqa_tpu.models import config as JC
from vivqa_tpu.models import convert as JCV
from vivqa_tpu.models.encoders import deberta as JD
from vivqa_tpu.models.encoders.resnet import ResNetEncoder as JResNet
from vivqa_tpu.models.encoders.swin import SwinEncoder as JSwin
from vivqa_tpu.models.encoders.text import TextEncoder as JText
from vivqa_tpu.models.encoders.vit import ViTEncoder as JViT
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models import convert as PCV
from vivqa_tpu_torch.models import hf_files
from vivqa_tpu_torch.models.encoders import ResNetEncoder, SwinEncoder
from vivqa_tpu_torch.models.encoders import TextEncoder, ViTEncoder
from vivqa_tpu_torch.models.encoders import deberta as PD
from vivqa_tpu_torch.models.from_jax import flatten_params, load_flax_params

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

ATOL = 3e-3


@contextlib.contextmanager
def _blocked():
    """``transformers`` unimportable, as on the card's machine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


def _perturbed(hf, seed: int):
    """Seeded noise on every parameter; BatchNorm statistics random."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, b in hf.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))
    return hf.eval()


# -- the nine converters ------------------------------------------------------
def _text_ids(seed, low=0):
    ids = np.random.RandomState(seed).randint(max(low, 2), 100, (2, 8))
    return ids, np.ones((2, 8), np.int64)


def _pixels(size, seed):
    return np.random.RandomState(seed).rand(2, size, size, 3).astype(
        np.float32)


def _bert(T):
    return T.BertModel(T.BertConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=16, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=False)


def _roberta(T):
    return T.RobertaModel(T.RobertaConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=20, type_vocab_size=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        pad_token_id=1), add_pooling_layer=False)


def _bart(T):
    return T.MBartModel(T.MBartConfig(
        vocab_size=100, d_model=32, encoder_layers=2, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=20,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        activation_function="gelu", scale_embedding=True, pad_token_id=1))


def _vit(T):
    return T.ViTModel(T.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=False)


def _clip(T):
    return T.CLIPVisionModel(T.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=8,
        attention_dropout=0.0))


def _resnet(T):
    return T.ResNetModel(T.ResNetConfig(
        embedding_size=8, hidden_sizes=[32, 64], depths=[1, 1],
        layer_type="bottleneck", num_channels=3))


def _swin(T):
    return T.SwinModel(T.SwinConfig(
        image_size=56, patch_size=4, embed_dim=8, depths=[2, 2],
        num_heads=[2, 4], window_size=7, num_channels=3, drop_path_rate=0.0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=False)


def _dinov2(T):
    return T.Dinov2Model(T.Dinov2Config(
        image_size=28, patch_size=7, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, mlp_ratio=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layerscale_value=0.5))


def _deberta(T):
    return T.DebertaV2Model(T.DebertaV2Config(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, relative_attention=True,
        position_buckets=8, max_relative_positions=32,
        norm_rel_ebd="layer_norm", pos_att_type=["p2c", "c2p"],
        position_biased_input=False, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, type_vocab_size=0,
        share_att_key=True))


def _text_cfg(mod, norm_style, layers, types=1):
    return mod.TextEncoderConfig(
        vocab_size=100, hidden_dim=32, num_layers=layers, num_heads=2,
        mlp_ratio=2.0, max_length=8, type_vocab_size=types, dropout=0.0,
        norm_style=norm_style, activation="gelu", dtype="float32")


def _vit_cfg(mod, **kw):
    return mod.VisualEncoderConfig(**{
        "hidden_dim": 32, "num_layers": 2, "num_heads": 2, "mlp_ratio": 2.0,
        "dropout": 0.0, "activation": "gelu", "dtype": "float32", **kw})


def _deberta_cfg(mod):
    return mod.DeBERTaConfig(
        vocab_size=100, hidden_dim=32, num_layers=2, num_heads=2,
        mlp_ratio=2.0, max_length=8, position_buckets=8,
        max_relative_positions=32, pos_att_type=("p2c", "c2p"),
        norm_rel_ebd=True, dropout=0.0, activation="gelu", ln_eps=1e-7,
        dtype="float32")


# name: (HF model factory, encoder config in a package's config module,
# JAX encoder class, port encoder class, inputs, the JAX converter's
# extra arguments, the port converter, its extra arguments)
CASES = {
    "bert": (_bert, lambda m: _text_cfg(m, "post", 2, 2), JText, TextEncoder,
             "text", {}, PCV.convert_bert, {}),
    "roberta": (_roberta, lambda m: _text_cfg(m, "post", 1), JText,
                TextEncoder, "text", {"pos_offset": 2}, PCV.convert_bert,
                {"pos_offset": 2}),
    "bart": (_bart, lambda m: _text_cfg(m, "pre", 2), JText, TextEncoder,
             "text", {}, PCV.convert_bart, {}),
    "vit": (_vit, lambda m: _vit_cfg(m, backbone="vit", image_size=32,
                                     patch_size=8), JViT, ViTEncoder,
            "image32", {}, PCV.convert_vit, {}),
    "clip_vision": (_clip, lambda m: _vit_cfg(
        m, backbone="clip", image_size=32, patch_size=8, vit_style="clip",
        activation="quick_gelu"), JViT, ViTEncoder, "image32", {},
        PCV.convert_clip_vision, {}),
    "resnet": (_resnet, lambda m: m.VisualEncoderConfig(
        backbone="resnet", image_size=32, resnet_width=8,
        resnet_stages=(1, 1), resnet_norm="frozen_bn", dtype="float32"),
        JResNet, ResNetEncoder, "image32", {}, PCV.convert_resnet, {}),
    "swin": (_swin, lambda m: m.VisualEncoderConfig(
        backbone="swin", image_size=56, swin_embed_dim=8,
        swin_depths=(2, 2), swin_heads=(2, 4), swin_window=7, dropout=0.0,
        activation="gelu", ln_eps=1e-5, dtype="float32"),
        JSwin, SwinEncoder, "image56", {}, PCV.convert_swin, {}),
    "dinov2": (_dinov2, lambda m: _vit_cfg(
        m, backbone="dino", image_size=28, patch_size=7,
        layer_scale_init=0.5), JViT, ViTEncoder, "image28", {},
        PCV.convert_dinov2, {}),
    "deberta": (_deberta, _deberta_cfg, JD.DeBERTaEncoder,
                PD.DeBERTaEncoder, "text", {}, PCV.convert_deberta, {}),
}


def _inputs(kind, seed):
    if kind == "text":
        ids, mask = _text_ids(seed, low=2)
        return (ids, mask)
    return (_pixels(int(kind[5:]), seed),)


def _hf_output(name, hf, args):
    """The HF model's output on ``args`` as (pooled or None, tokens)."""
    with torch.no_grad():
        if len(args) == 2:
            ids, mask = (torch.tensor(a) for a in args)
            run = hf.get_encoder() if name == "bart" else hf
            return None, run(input_ids=ids, attention_mask=mask
                             ).last_hidden_state.numpy()
        out = hf(pixel_values=torch.tensor(args[0].transpose(0, 3, 1, 2)))
    h = out.last_hidden_state.numpy()
    if name == "clip_vision":
        return out.pooler_output.numpy(), h[:, 1:]
    if name in ("vit", "dinov2"):
        return h[:, 0], h[:, 1:]
    if name == "resnet":
        B, C, H, W = h.shape
        return None, h.transpose(0, 2, 3, 1).reshape(B, H * W, C)
    return None, h


def _jax_config(name, cfg_fn):
    return cfg_fn(JD if name == "deberta" else JC)


def _port_config(name, cfg_fn):
    return cfg_fn(PD if name == "deberta" else PC)


@pytest.fixture(scope="module", params=list(CASES))
def converted(request, tmp_path_factory):
    """One architecture: the HF model saved to disk, the JAX converter's
    tree of the in-memory model and its encoder's output (one jitted
    apply), the port's tree read from disk with ``transformers`` blocked,
    and the port encoder's output."""
    name = request.param
    build, cfg_fn, jcls, pcls, kind, jkw, pconv, pkw = CASES[name]
    torch.manual_seed(0)
    hf = _perturbed(build(transformers), seed=1)
    d = tmp_path_factory.mktemp(name)
    hf.save_pretrained(d)
    args = _inputs(kind, seed=2)
    want = _hf_output(name, hf, args)
    jcfg = _jax_config(name, cfg_fn)
    jconv = getattr(JCV, pconv.__name__)
    jtree = jax.tree.map(np.asarray, jconv(hf, jcfg, **jkw))
    jout = jax.jit(lambda p, *a: jcls(jcfg).apply({"params": p}, *a))(
        jtree, *(jnp.asarray(a) for a in args))
    with _blocked():
        hf_cfg, sd = hf_files.load_hf_checkpoint(d)
        ptree = pconv(sd, hf_cfg, _port_config(name, cfg_fn), **pkw)
    port = load_flax_params(pcls(_port_config(name, cfg_fn)), ptree).eval()
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        pout = port(*targs)
    return {"name": name, "dir": d, "hf_out": want, "jtree": jtree,
            "ptree": ptree, "jout": jout, "pout": pout}


def test_converted_tree_equals_jax_leaf_for_leaf(converted):
    jflat = flatten_params(converted["jtree"])
    pflat = flatten_params(converted["ptree"])
    assert set(pflat) == set(jflat)
    for path, want in jflat.items():
        got = pflat[path]
        assert got.dtype == np.float32 and got.shape == want.shape, path
        if converted["name"] == "resnet" and "norm" in path:
            # the BatchNorm fold: one rounding of difference at most
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


def test_port_encoder_matches_hf_and_jax(converted):
    pooled, tokens = converted["hf_out"]
    pout, jout = converted["pout"], converted["jout"]
    np.testing.assert_allclose(pout["tokens"].numpy(), tokens, atol=ATOL)
    if pooled is not None:
        np.testing.assert_allclose(pout["pooled"].numpy(), pooled,
                                   atol=ATOL)
    for key in ("tokens", "pooled"):
        assert_close(pout[key], np.asarray(jout[key]), **F32_TOL, msg=key)


# -- the reader's file forms -------------------------------------------------
def _tiny_roberta(prefixed: bool):
    T = transformers
    cfg = T.RobertaConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=32,
                          max_position_embeddings=12, type_vocab_size=1,
                          pad_token_id=1)
    torch.manual_seed(3)
    model = T.RobertaForMaskedLM(cfg) if prefixed else T.RobertaModel(
        cfg, add_pooling_layer=False)
    return _perturbed(model, seed=4)


def _base_state(model) -> dict:
    """The base model's tensors by their own key names."""
    base = getattr(model, model.base_model_prefix, model)
    return {k: v.detach().clone() for k, v in base.state_dict().items()}


@pytest.mark.parametrize("form", ["safetensors", "bin", "sharded_safetensors",
                                  "sharded_bin"])
@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "prefixed"])
def test_reader_takes_every_file_form(tmp_path, form, prefixed):
    """safetensors (parsed by hand), ``pytorch_model.bin`` and the sharded
    index forms of both, from a bare ``RobertaModel`` and from a
    ``RobertaForMaskedLM`` (its ``roberta.`` prefix stripped, its LM head
    ignored): every tensor of the base model, bit-equal."""
    model = _tiny_roberta(prefixed)
    kw = {"safe_serialization": not form.endswith("bin")}
    if form.startswith("sharded"):
        kw["max_shard_size"] = "4KB"
    model.save_pretrained(tmp_path, **kw)
    files = {p.name for p in tmp_path.iterdir()}
    index = {"sharded_safetensors": hf_files.SAFE_INDEX,
             "sharded_bin": hf_files.TORCH_INDEX}.get(form)
    if index:
        assert index in files
        assert len(json.loads((tmp_path / index).read_text())
                   ["weight_map"]) > 1
    with _blocked():
        cfg, sd = hf_files.load_hf_checkpoint(tmp_path)
    assert cfg["model_type"] == "roberta"
    want = _base_state(model)
    for key, t in want.items():
        if key.endswith("position_ids"):
            continue
        assert torch.equal(sd[key], t), key


def test_safetensors_dtypes(tmp_path):
    """F32, F16, BF16, I64 and BOOL, written in the format's layout (u64
    header length, JSON header, raw bytes), read bit for bit."""
    tensors = {"f32": torch.randn(3, 5), "f16": torch.randn(7).half(),
               "bf16": torch.randn(2, 3).bfloat16(),
               "i64": torch.arange(6).reshape(2, 3),
               "bool": torch.tensor([True, False, True])}
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.bool: "BOOL"}
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes() \
            if t.dtype != torch.bool else t.numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    path = tmp_path / "x.safetensors"
    path.write_bytes(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    got = hf_files.read_safetensors(path)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def test_mbart_tied_table_resolves_to_shared(tmp_path):
    """A ``save_pretrained`` mBART keeps ``shared.weight`` alone; the
    encoder's ``embed_tokens.weight`` resolves to it."""
    torch.manual_seed(5)
    hf = _perturbed(_bart(transformers), seed=6)
    hf.save_pretrained(tmp_path)
    with _blocked():
        _, sd = hf_files.load_hf_checkpoint(tmp_path)
    assert "shared.weight" in sd._tensors
    assert "encoder.embed_tokens.weight" not in sd._tensors
    assert torch.equal(sd["encoder.embed_tokens.weight"],
                       hf.shared.weight.detach())


def _fake_cache(root: Path, name: str, model) -> Path:
    repo = root / ("models--" + name.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd")
    snap = repo / "snapshots" / "0123abcd"
    model.save_pretrained(snap)
    return snap


@pytest.mark.parametrize("env", ["HF_HUB_CACHE", "HF_HOME"])
def test_hub_name_resolves_in_the_local_cache_only(tmp_path, monkeypatch,
                                                   env):
    """``org/name`` resolves through ``refs/main`` to its snapshot under
    $HF_HUB_CACHE (or $HF_HOME/hub); a name absent from the cache raises
    ``OSError``, as ``from_pretrained(..., local_files_only=True)``."""
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.delenv("HF_HOME", raising=False)
    root = tmp_path / "hub"
    monkeypatch.setenv(env, str(root if env == "HF_HUB_CACHE" else tmp_path))
    snap = _fake_cache(root, "vinai/phobert-tiny", _tiny_roberta(True))
    with _blocked():
        assert hf_files.resolve_model_dir("vinai/phobert-tiny") == snap
        enc, tree = PCV.load_pretrained_text_encoder(
            "vinai/phobert-tiny", PC.TextEncoderConfig(max_length=8))
        assert enc.config.hidden_dim == 16 and "layers_0" in tree
        with pytest.raises(OSError):
            hf_files.resolve_model_dir("vinai/phobert-base")
        with pytest.raises(OSError):
            PCV.load_pretrained_visual_encoder(
                "openai/clip-vit-base-patch32", PC.VisualEncoderConfig())
        with pytest.raises(OSError):
            hf_files.resolve_model_dir(tmp_path / "no_such_dir")


def test_missing_needed_key_raises_naming_it(tmp_path):
    """A tensor a converter needs and the files lack raises ``KeyError``
    naming the key (``AutoModel`` would initialise it at random)."""
    model = _tiny_roberta(False)
    model.save_pretrained(tmp_path)
    state = hf_files.read_safetensors(tmp_path / hf_files.SAFE_WEIGHTS)
    state.pop("encoder.layer.0.attention.self.key.bias")
    torch.save(state, tmp_path / hf_files.TORCH_WEIGHTS)
    (tmp_path / hf_files.SAFE_WEIGHTS).unlink()
    with _blocked(), pytest.raises(
            KeyError, match="encoder.layer.0.attention.self.key.bias"):
        PCV.load_pretrained_text_encoder(tmp_path,
                                         PC.TextEncoderConfig(max_length=8))


# -- the loaders against the JAX loaders -------------------------------------
LOADER_CASES = {
    "phobert_prefixed": (lambda: _tiny_roberta(True), "text"),
    "bert": (lambda: _perturbed(_bert(transformers), 7), "text"),
    "bartpho": (lambda: _perturbed(_bart(transformers), 8), "text"),
    "vit_classifier": (lambda: _perturbed(transformers.ViTForImageClassification(
        _vit(transformers).config), 9), "visual"),
    "clip": (lambda: _perturbed(transformers.CLIPModel(transformers.CLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=16),
        vision_config=_clip(transformers).config.to_dict(),
        projection_dim=16)), 10), "visual"),
    "clip_vision": (lambda: _perturbed(_clip(transformers), 11), "visual"),
    "resnet": (lambda: _perturbed(_resnet(transformers), 12), "visual"),
    "swin": (lambda: _perturbed(_swin(transformers), 13), "visual"),
    "dinov2": (lambda: _perturbed(_dinov2(transformers), 14), "visual"),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_jax_loader(tmp_path, case):
    """The re-derived encoder config equals the JAX loader's field by
    field and the converted trees are equal (the port reading with
    ``transformers`` blocked); a too-long text asks raises as in JAX."""
    build, kind = LOADER_CASES[case]
    torch.manual_seed(0)
    build().save_pretrained(tmp_path)
    if kind == "text":
        jcfg = JC.TextEncoderConfig(max_length=8, dropout=0.0)
        pcfg = PC.TextEncoderConfig(max_length=8, dropout=0.0)
        jload, pload = (JCV.load_pretrained_text_encoder,
                        PCV.load_pretrained_text_encoder)
    else:
        size = {"resnet": 32, "swin": 56, "dinov2": 28}.get(case, 32)
        jcfg = JC.VisualEncoderConfig(image_size=size)
        pcfg = PC.VisualEncoderConfig(image_size=size)
        jload, pload = (JCV.load_pretrained_visual_encoder,
                        PCV.load_pretrained_visual_encoder)
    jenc, jtree = jload(str(tmp_path), jcfg)
    with _blocked():
        penc, ptree = pload(tmp_path, pcfg)
    assert penc.config.to_dict() == jenc.config.to_dict()
    jflat = flatten_params(jax.tree.map(np.asarray, jtree))
    pflat = flatten_params(ptree)
    assert set(pflat) == set(jflat)
    for path, want in jflat.items():
        np.testing.assert_array_max_ulp(pflat[path], want, maxulp=1)
    # the tree grafts into the module the loader built
    load_flax_params(penc, ptree)
    if kind == "text":
        with pytest.raises(ValueError, match="usable positions"):
            jload(str(tmp_path), jcfg.replace(max_length=64))
        with _blocked(), pytest.raises(ValueError,
                                                 match="usable positions"):
            pload(tmp_path, pcfg.replace(max_length=64))


def test_loader_refuses_unknown_architectures(tmp_path):
    """DeBERTa has a converter but no loader dispatch, as in JAX."""
    torch.manual_seed(0)
    _perturbed(_deberta(transformers), 15).save_pretrained(tmp_path)
    with pytest.raises(ValueError, match="no converter"):
        JCV.load_pretrained_visual_encoder(str(tmp_path),
                                           JC.VisualEncoderConfig())
    with _blocked(), pytest.raises(ValueError,
                                             match="no converter"):
        PCV.load_pretrained_visual_encoder(tmp_path,
                                           PC.VisualEncoderConfig())


def test_dinov2_graft_quirk_image_size_not_rederived(tmp_path):
    """The DINOv2 branch keeps the pipeline's image_size: a checkpoint at
    another size loads, then fails at the graft on ``pos_embed``'s
    shape (the JAX package's own behaviour)."""
    from vivqa_tpu_torch.models.vqa_model import VietnameseVQAModel
    torch.manual_seed(0)
    _perturbed(_dinov2(transformers), 16).save_pretrained(tmp_path)
    with _blocked():
        enc, tree = PCV.load_pretrained_visual_encoder(
            tmp_path, PC.VisualEncoderConfig(image_size=56))
    jenc, _ = JCV.load_pretrained_visual_encoder(
        str(tmp_path), JC.VisualEncoderConfig(image_size=56))
    assert enc.config.image_size == jenc.config.image_size == 56
    cfg = PC.VQAModelConfig(
        visual=enc.config.replace(dtype="float32"),
        text=PC.TextEncoderConfig(vocab_size=50, hidden_dim=32, num_layers=1,
                                  num_heads=2, max_length=8),
        fusion=PC.FusionConfig(hidden_dim=32, num_heads=2, num_layers=1),
        num_answers=4)
    model = VietnameseVQAModel(cfg)
    with pytest.raises(ValueError, match="pos_embed"):
        PCV.graft_pretrained(model, "visual_encoder", tree)


# -- the graft's strict errors (test_convert.py:test_graft_pretrained_strict) --
class _Towers(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.visual_encoder = torch.nn.Module()
        self.visual_encoder.patch_embed = torch.nn.Conv2d(3, 4, 2)
        self.head = torch.nn.Module()
        self.head.w = torch.nn.Parameter(torch.zeros(5))


def test_graft_pretrained_strict():
    model = _Towers()
    conv = {"patch_embed": {"kernel": np.ones((2, 2, 3, 4), np.float32),
                            "bias": np.full(4, 2.0, np.float32)}}
    out = PCV.graft_pretrained(model, "visual_encoder", conv)
    assert out is model
    assert torch.equal(model.visual_encoder.patch_embed.weight,
                       torch.ones(4, 3, 2, 2))
    assert torch.equal(model.visual_encoder.patch_embed.bias,
                       torch.full((4,), 2.0))
    assert torch.equal(model.head.w, torch.zeros(5))  # untouched

    before = model.visual_encoder.patch_embed.weight.clone()
    with pytest.raises(KeyError, match="no tower"):
        PCV.graft_pretrained(model, "nope", conv)
    with pytest.raises(ValueError, match="structure mismatch"):
        PCV.graft_pretrained(model, "visual_encoder",
                             {"patch_embed": {"kernel": conv["patch_embed"]
                                              ["kernel"]}})
    with pytest.raises(ValueError, match="shape"):
        PCV.graft_pretrained(model, "visual_encoder", {"patch_embed": {
            "kernel": np.ones((9, 9, 3, 4), np.float32),
            "bias": np.ones(4, np.float32)}})
    # a refused graft writes nothing
    assert torch.equal(model.visual_encoder.patch_embed.weight, before)


def test_config_defaults_are_the_config_classes():
    """The reader's defaults for fields a config.json may leave out are
    those of the transformers config classes."""
    T = transformers
    classes = {"bert": T.BertConfig, "roberta": T.RobertaConfig,
               "xlm-roberta": T.XLMRobertaConfig, "mbart": T.MBartConfig,
               "bart": T.BartConfig, "vit": T.ViTConfig,
               "clip_vision_model": T.CLIPVisionConfig,
               "resnet": T.ResNetConfig, "swin": T.SwinConfig,
               "dinov2": T.Dinov2Config, "deberta-v2": T.DebertaV2Config}
    for mt, cls in classes.items():
        default = cls()
        for field, value in hf_files.CONFIG_DEFAULTS[mt].items():
            assert getattr(default, field) == value, (mt, field)
