"""The port's host-side data layer against the JAX package, on the CPU:
the synthetic corpus, raw loading and splitting, the train-mode image
augmentation (PIL path bit for bit), the native loader through ctypes
against the JAX package's cffi binding of the same library, text
augmentation, the dropout scheduler, the u8 wire format, the batch
loader, the device prefetcher, and the whole ``DataPipeline`` (train,
val and test batches over two epochs, on the PIL and native paths)."""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivqa_tpu.data import augmentation as JA
from vivqa_tpu.data import fastloader as JF
from vivqa_tpu.data import actions as JACT
from vivqa_tpu.data.loader import BatchLoader as JBatchLoader
from vivqa_tpu.data.synthetic import generate_synthetic_vivqa as j_generate
from vivqa_tpu.pipelines import data_pipeline as JDP
from vivqa_tpu_torch.data import augmentation as PA
from vivqa_tpu_torch.data import fastloader as PF
from vivqa_tpu_torch.data import actions as PACT
from vivqa_tpu_torch.data.loader import BatchLoader, device_prefetch
from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
from vivqa_tpu_torch.pipelines import data_pipeline as PDP

torch.set_num_threads(1)

N, S = 32, 16      # corpus size and image side, as tests/test_pipelines.py


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same learnable corpus written by both generators."""
    jd, pd = (tmp_path_factory.mktemp(n) for n in ("jax", "port"))
    j_generate(jd, n=N, image_size=S, learnable=True, seed=3)
    csv, imgs = generate_synthetic_vivqa(pd, n=N, image_size=S,
                                         learnable=True, seed=3)
    return jd, pd, str(csv), str(imgs)


def _asdicts(samples):
    return [dataclasses.asdict(s) for s in samples]


# -- corpus, raw loading, splitting ------------------------------------------
def test_synthetic_corpus_is_byte_identical(corpus):
    jd, pd, _, _ = corpus
    for name in ("data.csv", "manifest.json"):
        assert (pd / name).read_bytes() == (jd / name).read_bytes(), name
    names = sorted(p.name for p in (jd / "images").iterdir())
    assert len(names) == N
    assert sorted(p.name for p in (pd / "images").iterdir()) == names
    for n in names:
        assert (pd / "images" / n).read_bytes() == \
            (jd / "images" / n).read_bytes(), n


def test_load_split_statistics_match(corpus):
    _, _, csv, imgs = corpus
    js = JACT.load_raw_data(csv, imgs)
    ps = PACT.load_raw_data(csv, imgs)
    assert _asdicts(ps) == _asdicts(js)
    assert _asdicts(PACT.load_raw_data(csv, imgs, max_samples=5)) == \
        _asdicts(JACT.load_raw_data(csv, imgs, max_samples=5))
    for ratios in ((0.8, 0.1), (0.5, 0.25)):
        for a, b in zip(PACT.split_data(ps, *ratios, seed=7),
                        JACT.split_data(js, *ratios, seed=7)):
            assert _asdicts(a) == _asdicts(b)
    assert PACT.data_statistics(ps) == JACT.data_statistics(js)
    assert PACT.build_image_index(imgs) == JACT.build_image_index(imgs)
    for raw in ("['a', 'b']", "plain", ["x", 1], "[broken"):
        assert PACT.parse_answers(raw) == JACT.parse_answers(raw)


# -- image augmentation -------------------------------------------------------
@pytest.mark.parametrize("strength", ["light", "medium", "strong"])
@pytest.mark.parametrize("normalize", [True, False])
def test_train_augmentation_pil_path_bit_for_bit(corpus, strength,
                                                 normalize):
    """The same seed gives the same pixels over a sequence of calls: the
    draws are consumed in the JAX package's order (the erase after the
    resize), on images, arrays and a missing file."""
    _, _, csv, imgs = corpus
    paths = sorted(str(p) for p in Path(imgs).iterdir())[:12]
    rs = np.random.RandomState(0)
    inputs = paths + [rs.randint(0, 256, (20, 24, 3), dtype=np.uint8),
                      rs.rand(S, S, 3).astype(np.float32),
                      "/nonexistent.jpg"]
    j = JA.ImageAugmentation(S, "train", strength, seed=11,
                             normalize=normalize)
    p = PA.ImageAugmentation(S, "train", strength, seed=11,
                             normalize=normalize)
    for x in inputs:
        got, want = p(x), j(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert p.rng.getstate() == j.rng.getstate()


def test_augmentation_rejects_unknown_mode_and_strength():
    with pytest.raises(ValueError, match="strength"):
        PA.ImageAugmentation(S, "train", "extreme")
    with pytest.raises(ValueError, match="mode"):
        PA.ImageAugmentation(S, "test")


# -- native loader: ctypes against the JAX package's cffi binding -------------
def test_native_loader_loads_here():
    """Both bindings load native/libfastloader.so on this host, so the
    native path below is really compared."""
    assert PF.is_available() and JF.is_available()


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("normalize", [True, False])
def test_native_batch_matches_jax(corpus, mode, normalize):
    """ImageAugmentation.batch: the same seeds (one getrandbits(63) per
    batch), the same per-image streams, the same placeholders for a
    missing file and the PIL retry for a file that is not a JPEG."""
    _, pd, _, imgs = corpus
    png = pd / "not_a_jpeg.png"
    from PIL import Image
    Image.fromarray(np.full((S, S, 3), 90, np.uint8)).save(png)
    paths = sorted(str(p) for p in Path(imgs).iterdir())[:9]
    paths += ["/nonexistent.jpg", str(png)]
    j = JA.ImageAugmentation(S, mode, "strong", seed=5, normalize=normalize)
    p = PA.ImageAugmentation(S, mode, "strong", seed=5, normalize=normalize)
    for _ in range(2):                  # the seed advances batch by batch
        got, want = p.batch(paths), j.batch(paths)
        assert got.dtype == want.dtype and got.shape == (11, S, S, 3)
        np.testing.assert_array_equal(got, want)
    assert p.batch([np.zeros((S, S, 3), np.uint8)]) is None


def test_native_decode_one_and_raw_calls_match(corpus):
    _, _, _, imgs = corpus
    path = sorted(Path(imgs).iterdir())[0]
    data = path.read_bytes()
    np.testing.assert_array_equal(PF.decode_one(data, 24),
                                  JF.decode_one(data, 24))
    assert PF.decode_one(b"not a jpeg", 24) is None
    paths = [str(p) for p in sorted(Path(imgs).iterdir())[:4]]
    for got, want in zip(PF.batch_load(paths, S, threads=3),
                         JF.batch_load(paths, S, threads=3)):
        np.testing.assert_array_equal(got, want)
    preset = PA.STRENGTH_PRESETS["medium"]
    for seed in (0, 2 ** 64 + 17, -1):       # taken to 64 bits, as JAX
        for got, want in zip(
                PF.batch_load_train(paths, S, preset, seed, threads=2),
                JF.batch_load_train(paths, S, preset, seed, threads=2)):
            np.testing.assert_array_equal(got, want)


# -- text augmentation, dropout schedule, u8 wire format ----------------------
def test_text_augmentation_matches_jax():
    qs = ["con mèo màu gì ?", "có bao nhiêu chiếc xe", "mèo",
          "trong ảnh có gì vậy bạn"] * 10
    for kw in ({}, {"enable_random_swap": False},
               {"enable_random_deletion": False},
               {"enable_random_deletion": False,
                "enable_random_swap": False}):
        for prob in (0.3, 1.0):
            j = JA.create_text_augmentation(prob, seed=4, **kw)
            p = PA.create_text_augmentation(prob, seed=4, **kw)
            assert [p(q) for q in qs] == [j(q) for q in qs]


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_dropout_scheduler_rates_match_jax(schedule):
    j = JA.DropoutScheduler(0.1, 0.3, total_steps=9, warmup_steps=2,
                            schedule=schedule)
    p = PA.DropoutScheduler(0.1, 0.3, total_steps=9, warmup_steps=2,
                            schedule=schedule)
    assert [p.get_dropout(s) for s in range(12)] == \
        [j.get_dropout(s) for s in range(12)]
    assert [p.step() for _ in range(12)] == [j.step() for _ in range(12)]
    with pytest.raises(ValueError, match="schedule"):
        PA.DropoutScheduler(schedule="step")


def _tiny_model_config(mod, use_moe: bool = True):
    return mod.VQAModelConfig(
        visual=mod.VisualEncoderConfig(image_size=16, patch_size=8,
                                       hidden_dim=32, num_layers=1,
                                       num_heads=2, dtype="float32"),
        text=mod.TextEncoderConfig(vocab_size=40, hidden_dim=32,
                                   num_layers=1, num_heads=2, max_length=8,
                                   dtype="float32"),
        fusion=mod.FusionConfig(fusion_type="mcan", hidden_dim=32,
                                num_heads=2, num_layers=1),
        moe=mod.MoEModelConfig(use_moe=use_moe, num_experts=2, top_k=1,
                               expert_hidden_dim=32),
        num_answers=6, dtype="float32")


def test_dropout_apply_to_config_matches_jax():
    from vivqa_tpu.models import config as JC
    from vivqa_tpu_torch.models import config as PC
    for rate in (0.0, 0.25):
        assert PA.DropoutScheduler.apply_to_config(
            _tiny_model_config(PC), rate).to_dict() == \
            JA.DropoutScheduler.apply_to_config(
                _tiny_model_config(JC), rate).to_dict()


def test_dropout_apply_to_model_sets_live_rates():
    """The live model's rates become those of a model built from the
    rate-substituted config, parameters untouched, the MoE experts' 0.1
    kept; a train-mode forward then equals that model's bit for bit."""
    from vivqa_tpu_torch.models import config as PC
    from vivqa_tpu_torch.models.vqa_model import create_vqa_model
    cfg = _tiny_model_config(PC)
    model = create_vqa_model(cfg, device="cpu")
    params = {n: p for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in params.items()}
    PA.DropoutScheduler.apply_to_model(model, 0.3)
    ref = create_vqa_model(PA.DropoutScheduler.apply_to_config(cfg, 0.3),
                           device="cpu")
    ref.load_state_dict(model.state_dict())
    rates = {}
    for (name, m), (_, r) in zip(model.named_modules(),
                                 ref.named_modules()):
        for attr in ("dropout", "dropout_rate"):
            if attr in vars(r):
                assert getattr(m, attr) == getattr(r, attr), (name, attr)
                rates[f"{name}.{attr}"] = getattr(m, attr)
        if "config" in vars(r):
            assert m.config == r.config, name
    assert rates["moe.dropout"] == 0.1
    assert {v for k, v in rates.items() if k != "moe.dropout"} == {0.3}
    for n, p in model.named_parameters():
        assert p is params[n] and torch.equal(p, before[n])
    rs = np.random.RandomState(0)
    px = torch.from_numpy(rs.standard_normal((2, 16, 16, 3)).astype(
        np.float32))
    ids = torch.from_numpy(rs.randint(4, 40, (2, 8))).long()
    outs = []
    for m in (model, ref):
        m.train()
        outs.append(m(px, ids, generator=torch.Generator().manual_seed(1))[
            "logits"])
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert PA.DropoutScheduler.apply_to_model(model, 0.3) is model


def test_normalize_pixels_on_device_matches_jax():
    """uint8 -> (x/255 - mean)/std in f32 within 2 ulp; floats pass
    through untouched."""
    rs = np.random.RandomState(2)
    u8 = rs.randint(0, 256, (2, S, S, 3), dtype=np.uint8)
    got = PA.normalize_pixels_on_device(torch.from_numpy(u8))
    want = np.asarray(JA.normalize_pixels_on_device(jnp.asarray(u8)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=2.5e-7)
    f = torch.from_numpy(rs.standard_normal((2, S, S, 3)).astype(np.float32))
    assert PA.normalize_pixels_on_device(f) is f
    # the u8 wire batch, normalized on the device, is the float path's
    aug_u8 = PA.ImageAugmentation(S, "eval", normalize=False)
    aug_f = PA.ImageAugmentation(S, "eval")
    x = rs.randint(0, 256, (S, S, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        PA.normalize_pixels_on_device(torch.from_numpy(aug_u8(x))).numpy(),
        aug_f(x), rtol=1e-6, atol=1e-6)


# -- batch loader and prefetcher ----------------------------------------------
class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int32),
                "f": np.full((3,), i / 2, np.float32), "tag": f"item{i}"}


def _collate(items):
    return {"x": np.stack([it["x"] for it in items]),
            "f": np.stack([it["f"] for it in items]),
            "tag": [it["tag"] for it in items]}


@pytest.mark.parametrize("drop_last,pad_last,shuffle", [
    (True, True, True), (False, True, False), (False, False, True)])
def test_batch_loader_matches_jax(drop_last, pad_last, shuffle):
    """Order (RandomState(seed + epoch)), drop_last, pad_last and
    _num_valid over three epochs."""
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
              pad_last=pad_last)
    p = BatchLoader(_Items(11), 4, _collate, **kw)
    j = JBatchLoader(_Items(11), 4, _collate, **kw)
    assert len(p) == len(j)
    for _ in range(3):
        pb, jb = list(p), list(j)
        assert len(pb) == len(jb)
        for a, b in zip(pb, jb):
            assert sorted(a) == sorted(b)
            np.testing.assert_array_equal(a["x"], b["x"])
            assert a["tag"] == b["tag"] and a["_num_valid"] == \
                b["_num_valid"]


def test_device_prefetch_on_the_cpu():
    """Arrays become CPU tensors (signed integers as int64, floats and
    uint8 as they are), host fields ride along, order is kept."""
    batches = [{"ids": np.arange(6, dtype=np.int32).reshape(2, 3) + i,
                "px": np.full((2, 2), i, np.float32),
                "u8": np.full((2,), i, np.uint8),
                "answers": [f"a{i}"], "_num_valid": i}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", buffer_size=2))
    assert len(out) == 5
    for i, (b, o) in enumerate(zip(batches, out)):
        assert o["ids"].dtype == torch.int64
        assert o["px"].dtype == torch.float32 and o["u8"].dtype == \
            torch.uint8
        np.testing.assert_array_equal(o["ids"].numpy(), b["ids"])
        np.testing.assert_array_equal(o["px"].numpy(), b["px"])
        assert o["answers"] == b["answers"] and o["_num_valid"] == i


def test_device_prefetch_raises_the_workers_error():
    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise KeyError("broken item")
    it = device_prefetch(gen(), "cpu")
    next(it)
    with pytest.raises(KeyError, match="broken item"):
        next(it)


def test_device_prefetch_stops_its_thread_when_the_consumer_stops():
    """A consumer that stops early (early stopping, max_eval_batches)
    stops the host thread, which is blocked on a full queue; under a
    short switch interval, with more producer work than the queue holds,
    every consumed batch is whole and in order."""
    import sys
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield {"x": np.full((64,), i, np.int64)}

    before = {t.ident for t in threading.enumerate()}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it = device_prefetch(gen(), "cpu", buffer_size=2)
        for i, b in enumerate(it):
            assert torch.equal(b["x"], torch.full((64,), i))
            if i == 20:
                break
        it.close()
    finally:
        sys.setswitchinterval(interval)
    deadline = time.time() + 10
    while time.time() < deadline and \
            {t.ident for t in threading.enumerate()} - before:
        time.sleep(0.01)
    assert not {t.ident for t in threading.enumerate()} - before
    assert len(produced) < 30


# -- the whole data pipeline --------------------------------------------------
def _pipeline_batches(mod, csv, imgs):
    """DataPipeline.run, then two epochs of train batches, the val and the
    test batches (the step-9 check already took one train batch)."""
    cfg = mod.DataPipelineConfig(
        csv_path=csv, image_dir=imgs, image_size=S, max_question_length=8,
        batch_size=8, augmentation_strength="medium",
        text_augmentation=0.5, seed=9)
    out = mod.DataPipeline(cfg).run()
    batches = [b for _ in range(2) for b in out.train_loader]
    batches += list(out.val_loader) + list(out.test_loader)
    return out, batches


def _assert_batches_equal(port, jax_):
    assert len(port) == len(jax_)
    for pb, jb in zip(port, jax_):
        assert sorted(pb) == sorted(jb)
        for k in ("pixel_values", "input_ids", "attention_mask", "labels"):
            assert pb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        for k in ("answer_counts", "all_answers", "question", "_num_valid"):
            assert pb[k] == jb[k], k


@pytest.mark.parametrize("path", ["pil", "native"])
def test_data_pipeline_batches_match_jax(corpus, monkeypatch, path):
    """Train (shuffled over two epochs, augmented, text-augmented), val
    and test (padded, ``_num_valid``) batches equal the JAX pipeline's:
    pixels bit for bit, ids, labels, answer counts."""
    _, _, csv, imgs = corpus
    if path == "pil":
        monkeypatch.setattr(PF, "get_fastloader", lambda: None)
        monkeypatch.setattr(JF, "get_fastloader", lambda: None)
    pout, pb = _pipeline_batches(PDP, csv, imgs)
    jout, jb = _pipeline_batches(JDP, csv, imgs)
    assert pout.answer2id == jout.answer2id
    assert pout.tokenizer.vocab == jout.tokenizer.vocab
    assert pout.statistics == jout.statistics
    _assert_batches_equal(pb, jb)
    assert [b["_num_valid"] for b in pb[-2:]] == [3, 4]   # val, test
    if path == "native":
        # the native path really ran: its train pixels are not the PIL
        # path's (other augmentation streams)
        monkeypatch.setattr(PF, "get_fastloader", lambda: None)
        _, pil = _pipeline_batches(PDP, csv, imgs)
        assert not np.array_equal(pil[0]["pixel_values"],
                                  pb[0]["pixel_values"])
        np.testing.assert_array_equal(pil[-1]["input_ids"],
                                      pb[-1]["input_ids"])


def test_data_pipeline_rejects_a_bad_batch():
    cfg = PDP.DataPipelineConfig(image_size=S, batch_size=2)
    pipe = PDP.DataPipeline(cfg)
    good = {"pixel_values": np.zeros((2, S, S, 3), np.float32),
            "input_ids": np.zeros((2, 8), np.int32),
            "attention_mask": np.zeros((2, 8), np.int32),
            "labels": np.array([0, 2], np.int32), "answer_counts": [{}, {}]}
    pipe._validate_batch(good, cfg, 3)
    with pytest.raises(ValueError, match="label out of range"):
        pipe._validate_batch(good, cfg, 2)
    with pytest.raises(ValueError, match="missing"):
        pipe._validate_batch({k: v for k, v in good.items()
                              if k != "answer_counts"}, cfg, 3)
    with pytest.raises(ValueError, match="pixel shape"):
        pipe._validate_batch({**good, "pixel_values": np.zeros(
            (2, S, S, 1), np.float32)}, cfg, 3)
