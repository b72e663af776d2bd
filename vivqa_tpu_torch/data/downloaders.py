"""Dataset / model / COCO-image downloaders (counterpart of
vivqa_tpu/data/downloaders.py).

Counterpart of src/data/download_data.py (Kaggle via kagglehub),
download_model.py (HF snapshot), download_coco_images.py (COCO URLs with
retry) in the reference. All are network operations — in a zero-egress
environment they raise a clear error up front instead of hanging.
``download_hf_model`` looks in the local HF cache first with the port's
own resolver (``models/hf_files.py``, as ``local_files_only=True``
does), then asks ``huggingface_hub`` where it is installed:

    python -m vivqa_tpu_torch.data.downloaders kaggle|hf-model|coco ...
"""

from __future__ import annotations

import argparse
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Sequence


class DownloadUnavailableError(RuntimeError):
    pass


def download_kaggle_dataset(dataset: str, out_dir: str | Path) -> Path:
    """Fetch a Kaggle dataset (VQA/ViVQA layouts) via kagglehub
    (reference download_data.py)."""
    try:
        import kagglehub
    except ImportError as e:
        raise DownloadUnavailableError(
            "kagglehub is not installed; place the CSV + images manually "
            "under the data directory (see configs/pipeline_config.yaml)"
        ) from e
    path = kagglehub.dataset_download(dataset)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return Path(path)


def _snapshot_download(name: str, **kwargs) -> str:
    """``huggingface_hub.snapshot_download``, imported when called (the
    package is optional)."""
    from huggingface_hub import snapshot_download
    return snapshot_download(name, **kwargs)


def download_hf_model(name: str, out_dir: str | Path | None = None) -> Path:
    """Snapshot a HF checkpoint for offline use (reference
    download_model.py). Tries the local cache first."""
    from vivqa_tpu_torch.models.hf_files import resolve_model_dir
    try:
        return resolve_model_dir(name)
    except OSError:
        pass
    try:
        return Path(_snapshot_download(name, local_dir=out_dir))
    except Exception as e:
        raise DownloadUnavailableError(
            f"cannot download '{name}' (no network, or no huggingface_hub?);"
            " pre-seed the HF cache or save the model to a directory and "
            "pass its path (vivqa_tpu_torch.models.convert reads it)"
        ) from e


COCO_URL_TEMPLATES = (
    "http://images.cocodataset.org/train2014/COCO_train2014_{iid:012d}.jpg",
    "http://images.cocodataset.org/val2014/COCO_val2014_{iid:012d}.jpg",
)


def download_coco_images(image_ids: Sequence[int], out_dir: str | Path,
                         retries: int = 3, delay: float = 1.0) -> dict:
    """Fetch COCO images by id with retry (reference
    download_coco_images.py). Returns {'ok': [...], 'failed': [...]}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok, failed = [], []
    for iid in image_ids:
        dest = out_dir / f"{int(iid):012d}.jpg"
        if dest.exists():
            ok.append(int(iid))
            continue
        success = False
        for url_tpl in COCO_URL_TEMPLATES:
            url = url_tpl.format(iid=int(iid))
            for attempt in range(retries):
                try:
                    urllib.request.urlretrieve(url, dest)
                    success = True
                    break
                except (urllib.error.URLError, OSError):
                    time.sleep(delay * (attempt + 1))
            if success:
                break
        (ok if success else failed).append(int(iid))
    return {"ok": ok, "failed": failed}


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset/model downloaders")
    sub = p.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kaggle")
    k.add_argument("dataset")
    k.add_argument("--out-dir", default="data")
    h = sub.add_parser("hf-model")
    h.add_argument("name")
    h.add_argument("--out-dir", default=None)
    c = sub.add_parser("coco")
    c.add_argument("ids", help="comma-separated image ids")
    c.add_argument("--out-dir", default="data/coco")
    args = p.parse_args(argv)
    if args.cmd == "kaggle":
        print(download_kaggle_dataset(args.dataset, args.out_dir))
    elif args.cmd == "hf-model":
        print(download_hf_model(args.name, args.out_dir))
    else:
        ids = [int(x) for x in args.ids.split(",") if x.strip()]
        print(download_coco_images(ids, args.out_dir))


if __name__ == "__main__":
    main()
