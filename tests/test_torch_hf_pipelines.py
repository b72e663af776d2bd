"""Pretrained HF towers through the port's pipelines and both CLIs, against
the JAX package's pipelines, on the CPU.

A CLIP vision tower and a PhoBERT-style RoBERTa (``RobertaForMaskedLM``,
so its keys carry the ``roberta.`` prefix) are built by ``transformers``
at tiny sizes, perturbed by seeded noise and saved with
``save_pretrained``; each pipeline reads them from disk (the port
without ``transformers``). The JAX pipelines run on a one-device mesh.

- The classification ``ModelPipeline`` and the generative pipeline's
  ``_setup`` re-derive the same model config as JAX's, their grafted
  towers equal JAX's grafted params leaf for leaf, and with the JAX
  pipeline's whole tree loaded the logits agree within
  ``assert_close_bf16`` (the fusions are forced to bf16 in both
  packages).
- Both CLIs train an epoch with ``--pretrained-visual`` and
  ``--pretrained-text``, the towers changed by training from the files'
  weights.
- A pretrained vision tower of another image size raises ``ValueError``
  in both pipelines, as in JAX; the generative pipeline warns when the
  tower's vocabulary is not the question tokenizer's.
"""

from __future__ import annotations

import contextlib
import math
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_support import assert_close_bf16, kept_prng_impl
from vivqa_tpu.models import config as JC
from vivqa_tpu.parallel import MeshConfig
from vivqa_tpu.parallel import create_mesh as j_create_mesh
from vivqa_tpu.pipelines import data_pipeline as JDP
from vivqa_tpu.pipelines import generative_vqa_pipeline as JGP
from vivqa_tpu.pipelines import model_pipeline as JMP
from vivqa_tpu_torch.data import generate_synthetic_vivqa
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.from_jax import (flatten_params, load_flax_params,
                                             to_flax)
from vivqa_tpu_torch.pipelines import data_pipeline as PDP
from vivqa_tpu_torch.pipelines import generative_training_pipeline as PGT
from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as PGP
from vivqa_tpu_torch.pipelines import model_pipeline as PMP
from vivqa_tpu_torch.pipelines import training_pipeline as PTP
from vivqa_tpu_torch.pipelines import vqa_pipeline as PVP
from vivqa_tpu_torch.train.optimizers import OptimizerConfig as POpt

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

N, S = 32, 16


def _perturbed(hf, seed: int):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return hf.eval()


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """(CLIP vision dir at S px, RoBERTa dir, CLIP vision dir at 2S px)."""
    T = transformers
    d = tmp_path_factory.mktemp("towers")
    torch.manual_seed(0)
    for name, size in (("clip", S), ("clip_big", 2 * S)):
        _perturbed(T.CLIPVisionModel(T.CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, image_size=size, patch_size=8)),
            1).save_pretrained(d / name)
    _perturbed(T.RobertaForMaskedLM(T.RobertaConfig(
        vocab_size=512, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=20, type_vocab_size=1, pad_token_id=1)),
        2).save_pretrained(d / "phobert")
    return str(d / "clip"), str(d / "phobert"), str(d / "clip_big")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_corpus")
    cls = generate_synthetic_vivqa(d / "cls", n=N, image_size=S,
                                   learnable=True)
    gen = generate_synthetic_vivqa(d / "gen", n=N, image_size=S,
                                   learnable=True, seq_answers=True)
    return [str(p) for p in cls], [str(p) for p in gen]


@contextlib.contextmanager
def _one_device():
    one = lambda c: j_create_mesh(c, devices=jax.devices("cpu")[:1])
    with pytest.MonkeyPatch.context() as mp, kept_prng_impl():
        mp.setattr(JMP, "create_mesh", one)
        mp.setattr(JGP, "create_mesh", one)
        yield


@contextlib.contextmanager
def _blocked():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


def _towers_equal(port_model, jparams, names):
    """Each tower's leaves of the port model equal JAX's, bit for bit."""
    for tower in names:
        want = flatten_params(jax.tree.map(np.asarray, jparams[tower]))
        module = getattr(port_model, tower)
        got = to_flax(module, dict(module.named_parameters()),
                      {p: a.shape for p, a in want.items()})
        assert set(got) == set(want), tower
        for path, a in want.items():
            np.testing.assert_array_equal(got[path], a,
                                          err_msg=f"{tower}/{path}")


# -- classification -----------------------------------------------------------
def _cls_model(mod):
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(image_size=S, dtype="float32"),
        text=mod.TextEncoderConfig(max_length=8, dropout=0.0,
                                   dtype="float32"),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1, dropout=0.0),
        head=mod.AnswerHeadConfig(dropout=0.0), num_answers=4,
        dtype="float32")


def test_model_pipeline_grafts_towers_as_jax(towers):
    clip, phobert, _ = towers
    with _one_device():
        jout = JMP.ModelPipeline(JMP.ModelPipelineConfig(
            model=_cls_model(JC), mesh=MeshConfig(model_axis=1), seed=3,
            pretrained_visual=clip, pretrained_text=phobert)).run()
    with _blocked():
        pout = PMP.ModelPipeline(PMP.ModelPipelineConfig(
            model=_cls_model(PC), device="cpu", seed=3,
            pretrained_visual=clip, pretrained_text=phobert)).run()
    model = pout.model
    assert model.config.to_dict() == jout.model.config.to_dict()
    assert model.config.visual.vit_style == "clip"
    assert model.config.text.norm_style == "post"
    _towers_equal(model, jout.params, ("visual_encoder", "text_encoder"))
    # the rest of the model from JAX's tree: the logits agree
    load_flax_params(model, jax.tree.map(np.asarray, jout.params))
    rs = np.random.RandomState(4)
    px = rs.rand(3, S, S, 3).astype(np.float32)
    ids = rs.randint(3, 512, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[1, 5:] = 0
    want = jout.model.apply({"params": jout.params}, px, ids, mask)["logits"]
    with torch.no_grad():
        got = model(torch.from_numpy(px), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long())["logits"]
    assert_close_bf16(got, np.asarray(want, np.float32), msg="logits")


def test_model_pipeline_refuses_another_image_size(towers):
    _, _, clip_big = towers
    with pytest.raises(ValueError, match="image_size"):
        PMP.ModelPipeline(PMP.ModelPipelineConfig(
            model=_cls_model(PC), device="cpu",
            pretrained_visual=clip_big)).run()
    with _one_device(), pytest.raises(ValueError, match="image_size"):
        JMP.ModelPipeline(JMP.ModelPipelineConfig(
            model=_cls_model(JC), mesh=MeshConfig(model_axis=1),
            pretrained_visual=clip_big)).run()


def test_classification_cli_trains_from_pretrained_towers(towers, corpora,
                                                          tmp_path,
                                                          monkeypatch):
    """``vqa_pipeline.main`` with ``--pretrained-visual`` and
    ``--pretrained-text``: an epoch trains from the grafted towers (their
    weights at the start are the files'), the loss finite."""
    clip, phobert, _ = towers
    (csv, imgs), _ = corpora
    cfg = PVP.VQAPipelineConfig(
        data=PDP.DataPipelineConfig(csv_path=csv, image_dir=imgs,
                                    image_size=S, max_question_length=8,
                                    batch_size=8,
                                    augmentation_strength="light"),
        model=PMP.ModelPipelineConfig(model=_cls_model(PC)),
        training=PTP.TrainingPipelineConfig(
            num_epochs=1, optimizer=POpt(learning_rate=1e-3),
            checkpoint_dir=str(tmp_path / "ck"), log_every=1),
        output_dir=str(tmp_path / "out"))
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(path)
    seen = {}
    real = PTP.TrainingPipeline.run

    def run(self, model, *args):
        seen["start"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        out = real(self, model, *args)
        seen["end"] = dict(model.named_parameters())
        return out
    monkeypatch.setattr(PTP.TrainingPipeline, "run", run)
    with _blocked():
        summary = PVP.main(["--config", str(path), "--device", "cpu",
                            "--mode", "train", "--pretrained-visual", clip,
                            "--pretrained-text", phobert])
    hist = summary["history"]
    assert len(hist) == 1 and math.isfinite(hist[0]["train_loss"])
    q = transformers.RobertaModel.from_pretrained(phobert)
    np.testing.assert_array_equal(
        seen["start"]["text_encoder.token_embed.weight"].numpy(),
        q.embeddings.word_embeddings.weight.detach().numpy())
    assert not torch.equal(seen["end"]["text_encoder.token_embed.weight"],
                           seen["start"]["text_encoder.token_embed.weight"])


# -- generative ---------------------------------------------------------------
def _gen_model(mod):
    return mod.GenerativeVQAConfig(
        visual=mod.VisualEncoderConfig(image_size=S, dtype="float32"),
        text=mod.TextEncoderConfig(max_length=8, dropout=0.0,
                                   dtype="float32"),
        fusion_dim=32, fusion_layers=1, fusion_heads=2, decoder_layers=1,
        decoder_heads=2, decoder_dim=32, decoder_ff_dim=64, dropout=0.0,
        dtype="float32")


def _gen_config(side, csv, imgs, tmp, **kw):
    dp, gp = (JDP, JGP) if side == "jax" else (PDP, PGP)
    extra = {"mesh": MeshConfig(model_axis=1)} if side == "jax" \
        else {"device": "cpu"}
    return gp.GenerativeVQAPipelineConfig(
        data=dp.DataPipelineConfig(
            csv_path=csv, image_dir=imgs, image_size=S,
            max_question_length=8, max_answer_length=6, batch_size=8,
            augmentation_strength="light", generative=True),
        model=_gen_model(JC if side == "jax" else PC),
        output_dir=str(tmp / f"out_{side}"), seed=5, **extra, **kw)


def test_generative_setup_grafts_towers_as_jax(towers, corpora, tmp_path):
    clip, phobert, _ = towers
    _, (csv, imgs) = corpora
    kw = dict(pretrained_visual=clip, pretrained_text=phobert)
    with _one_device():
        _, jmodel, jparams, _ = JGP.GenerativeVQAPipeline(
            _gen_config("jax", csv, imgs, tmp_path, **kw))._setup()
    pipe = PGP.GenerativeVQAPipeline(
        _gen_config("port", csv, imgs, tmp_path, **kw))
    warnings = []
    pipe.log.warning = lambda msg, *a: warnings.append(msg % a if a else msg)
    with _blocked():
        data_out, model = pipe._setup()
    assert model.config.to_dict() == jmodel.config.to_dict()
    assert any("vocab" in w for w in warnings)     # 512 != the corpus's
    _towers_equal(model, jparams, ("visual_encoder", "question_encoder"))
    load_flax_params(model, jax.tree.map(np.asarray, jparams))
    batch = next(iter(data_out.train_loader))
    args = [batch[k] for k in ("pixel_values", "question_ids",
                               "decoder_input_ids", "question_mask",
                               "decoder_mask")]
    want = jmodel.apply({"params": jparams}, *args)["logits"]
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.asarray(a)) if a.dtype.kind == "f"
                      else torch.from_numpy(np.asarray(a)).long()
                      for a in args))["logits"]
    assert_close_bf16(got, np.asarray(want, np.float32), msg="logits")


def test_generative_pipeline_refuses_another_image_size(towers, corpora,
                                                         tmp_path):
    _, _, clip_big = towers
    _, (csv, imgs) = corpora
    with pytest.raises(ValueError, match="image_size"):
        PGP.GenerativeVQAPipeline(_gen_config(
            "port", csv, imgs, tmp_path, pretrained_visual=clip_big))._setup()


def test_generative_cli_trains_from_pretrained_towers(towers, corpora,
                                                      tmp_path):
    clip, phobert, _ = towers
    _, (csv, imgs) = corpora
    cfg = _gen_config("port", csv, imgs, tmp_path).replace(
        training=PGT.GenerativeTrainingConfig(
            num_epochs=1, checkpoint_dir=str(tmp_path / "ck"),
            log_every=1))
    path = tmp_path / "gen.yaml"
    cfg.to_yaml(path)
    with _blocked():
        summary = PGP.main(["--config", str(path), "--device", "cpu",
                            "--mode", "train", "--pretrained-visual", clip,
                            "--pretrained-text", phobert])
    hist = summary["history"]
    assert len(hist) == 1 and math.isfinite(hist[0]["train_loss"])
