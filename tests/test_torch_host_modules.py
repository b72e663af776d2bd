"""The port's last host modules against the JAX package's:
``utils/visualization.py`` (headless sample rendering) and
``data/downloaders.py`` (Kaggle, HF and COCO fetchers that fail up front
without a network). Mirrors ``tests/test_native_and_utils.py:146-176``;
no test reaches the network: ``urlretrieve`` and ``snapshot_download``
are patched, and the HF lookup runs against a cache under ``tmp_path``.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from vivqa_tpu.data import downloaders as JD
from vivqa_tpu.utils import visualization as JV
from vivqa_tpu_torch.data import downloaders as PD
from vivqa_tpu_torch.utils import show_batch, show_sample
from vivqa_tpu_torch.utils import visualization as PV


def _no_network(*args, **kwargs):
    raise OSError("no network")


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """Both packages' fetchers cut off, the HF cache an empty directory;
    returns the calls the port made to ``snapshot_download``."""
    calls = []

    def snapshot(name, **kwargs):
        calls.append((name, kwargs))
        raise OSError("no network")
    monkeypatch.setattr(PD, "_snapshot_download", snapshot)
    monkeypatch.setattr(PD.urllib.request, "urlretrieve", _no_network)
    monkeypatch.setattr(JD.urllib.request, "urlretrieve", _no_network)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    return calls


def test_download_hf_model_absent_raises(offline):
    with pytest.raises(PD.DownloadUnavailableError, match="no network"):
        PD.download_hf_model("definitely/not-a-cached-model-xyz")
    assert offline == [("definitely/not-a-cached-model-xyz",
                        {"local_dir": None})]


def test_download_hf_model_finds_the_local_cache(offline, tmp_path):
    """A model in the local cache is returned without any fetch."""
    snap = tmp_path / "hub" / "models--org--tiny" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    (tmp_path / "hub" / "models--org--tiny" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--tiny" / "refs" / "main").write_text(
        "abc")
    assert PD.download_hf_model("org/tiny") == snap
    assert offline == []


def test_download_kaggle_without_kagglehub_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "kagglehub", None)
    for mod in (PD, JD):
        with pytest.raises(mod.DownloadUnavailableError, match="kagglehub"):
            mod.download_kaggle_dataset("org/vivqa", tmp_path)


def test_coco_downloader_handles_failures_as_jax(offline, tmp_path):
    """Every URL fails: the id is reported failed, as in JAX; an image
    already on disk is reported ok without a fetch."""
    got = PD.download_coco_images([123], tmp_path / "p", retries=2,
                                  delay=0.0)
    want = JD.download_coco_images([123], tmp_path / "j", retries=2,
                                   delay=0.0)
    assert got == want == {"ok": [], "failed": [123]}
    (tmp_path / "p" / f"{7:012d}.jpg").write_bytes(b"x")
    assert PD.download_coco_images([7, 8], tmp_path / "p", retries=1,
                                   delay=0.0) == {"ok": [7], "failed": [8]}
    assert PD.COCO_URL_TEMPLATES == JD.COCO_URL_TEMPLATES


def test_coco_downloader_retries_then_succeeds(monkeypatch, tmp_path):
    seen = []

    def flaky(url, dest):
        seen.append(url)
        if len(seen) < 2:
            raise OSError("transient")
        dest.write_bytes(b"jpeg")
    monkeypatch.setattr(PD.urllib.request, "urlretrieve", flaky)
    out = PD.download_coco_images([5], tmp_path, retries=3, delay=0.0)
    assert out == {"ok": [5], "failed": []}
    assert seen == [PD.COCO_URL_TEMPLATES[0].format(iid=5)] * 2


@pytest.mark.parametrize("argv,call", [
    (["kaggle", "org/vivqa", "--out-dir", "d"],
     ("download_kaggle_dataset", ("org/vivqa", "d"))),
    (["hf-model", "vinai/phobert-base"],
     ("download_hf_model", ("vinai/phobert-base", None))),
    (["coco", "1, 2,3", "--out-dir", "c"],
     ("download_coco_images", ([1, 2, 3], "c")))], ids=lambda v: str(v)[:20])
def test_main_dispatches_like_jax(monkeypatch, capsys, argv, call):
    for mod in (PD, JD):
        seen = []
        for name in ("download_kaggle_dataset", "download_hf_model",
                     "download_coco_images"):
            monkeypatch.setattr(mod, name, lambda *a, name=name: (
                seen.append((name, a)), "done")[1])
        mod.main(argv)
        assert seen == [call], mod.__name__
        assert capsys.readouterr().out.strip() == "done"


def test_show_sample_and_batch_as_jax(tmp_path):
    """Headless sample visualization writes the PNGs the JAX package's
    writes (the same bytes for the same inputs)."""
    img = (np.random.RandomState(0).rand(16, 16, 3) * 255).astype(np.uint8)
    outs = {}
    for side, mod in (("port", PV), ("jax", JV)):
        s = mod.show_sample(img, "màu gì?", "đỏ",
                            save_path=tmp_path / side / "s.png")
        g = mod.show_batch([img / 255.0, img, img], ["q1", "q2", "q3"],
                           [["a", "b"], "c", "d"], tmp_path / side / "g.png",
                           ncols=2)
        assert s.exists() and s.stat().st_size > 0
        assert g.exists() and g.stat().st_size > 0
        outs[side] = (s.read_bytes(), g.read_bytes())
    assert outs["port"] == outs["jax"]
    assert show_sample is PV.show_sample and show_batch is PV.show_batch
    assert PV.show_sample(img, "q", "a") is None     # nothing saved
