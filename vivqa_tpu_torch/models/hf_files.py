"""A reader of local Hugging Face model directories that needs neither
``transformers`` nor ``safetensors`` (the JAX package reads them through
``transformers.AutoModel.from_pretrained(..., local_files_only=True)``).

A model directory holds ``config.json`` and its weights in one of four
forms, tried in this order, as ``from_pretrained`` tries them:

- ``model.safetensors``: a little-endian u64 header length, a JSON header
  naming each tensor's dtype, shape and byte offsets, then the raw bytes
  (read here by hand, through ``torch.frombuffer``);
- ``model.safetensors.index.json``: its ``weight_map`` names the shard
  file of each tensor;
- ``pytorch_model.bin``: a ``torch.save`` state dict (read with
  ``weights_only=True`` on the CPU);
- ``pytorch_model.bin.index.json``: shards of those.

A name that is not a directory is looked up in the local HF cache only,
as ``local_files_only=True`` does: ``$HF_HUB_CACHE``, else
``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``, then
``models--{org}--{name}/refs/main`` names the snapshot under
``snapshots/``. Nothing is downloaded; a name or path that resolves to no
model directory raises ``OSError``, as ``from_pretrained`` does.

``load_hf_checkpoint`` gives the config (a dict, with the defaults of the
architecture's config class filled in for the fields the converters
read) and an ``HFStateDict``: tensors by the base model's key names. The
base-model prefix that a task head's checkpoint carries (``roberta.`` of
a ``RobertaForMaskedLM``, ``vit.`` of a ``ViTForImageClassification``,
``model.`` of an mBART seq2seq model...) is stripped; tied weights
resolve to the tensor that was saved (a ``save_pretrained`` mBART keeps
``shared.weight`` alone, and its encoder's ``embed_tokens.weight`` is
tied to it); a key the converters need and the files lack raises
``KeyError`` naming it, where ``AutoModel`` would initialise it at
random. Keys nobody reads (old ``position_ids`` buffers, a pooler, an LM
or classification head) are ignored.
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from pathlib import Path

import torch

CONFIG_NAME = "config.json"
SAFE_WEIGHTS = "model.safetensors"
SAFE_INDEX = "model.safetensors.index.json"
TORCH_WEIGHTS = "pytorch_model.bin"
TORCH_INDEX = "pytorch_model.bin.index.json"

_SAFE_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                "BF16": torch.bfloat16, "I64": torch.int64,
                "BOOL": torch.bool}

# the prefix a task head's checkpoint puts before the base model's keys
# (each architecture's ``base_model_prefix`` in transformers)
BASE_PREFIX = {"bert": "bert", "roberta": "roberta", "phobert": "roberta",
               "xlm-roberta": "roberta", "mbart": "model", "bart": "model",
               "vit": "vit", "swin": "swin", "resnet": "resnet",
               "dinov2": "dinov2", "deberta-v2": "deberta"}

# groups of keys tied to one tensor: a checkpoint keeps one of each
TIED = {"mbart": (("shared.weight", "encoder.embed_tokens.weight",
                   "decoder.embed_tokens.weight"),),
        "bart": (("shared.weight", "encoder.embed_tokens.weight",
                  "decoder.embed_tokens.weight"),)}

# the defaults of the transformers config classes for the fields the
# converters and loaders read (an older or hand-written config.json may
# leave them out)
CONFIG_DEFAULTS = {
    "bert": {"vocab_size": 30522, "hidden_size": 768,
             "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "max_position_embeddings": 512,
             "type_vocab_size": 2, "layer_norm_eps": 1e-12},
    "roberta": {"vocab_size": 50265, "hidden_size": 768,
                "num_hidden_layers": 12, "num_attention_heads": 12,
                "intermediate_size": 3072, "max_position_embeddings": 512,
                "type_vocab_size": 2, "layer_norm_eps": 1e-12},
    "xlm-roberta": {"vocab_size": 30522, "hidden_size": 768,
                    "num_hidden_layers": 12, "num_attention_heads": 12,
                    "intermediate_size": 3072,
                    "max_position_embeddings": 512, "type_vocab_size": 2},
    "mbart": {"vocab_size": 50265, "d_model": 1024, "encoder_layers": 12,
              "encoder_attention_heads": 16, "encoder_ffn_dim": 4096,
              "max_position_embeddings": 1024,
              "activation_function": "gelu", "scale_embedding": False},
    "bart": {"vocab_size": 50265, "d_model": 1024, "encoder_layers": 12,
             "encoder_attention_heads": 16, "encoder_ffn_dim": 4096,
             "max_position_embeddings": 1024,
             "activation_function": "gelu", "scale_embedding": False},
    "vit": {"hidden_size": 768, "num_hidden_layers": 12,
            "num_attention_heads": 12, "intermediate_size": 3072,
            "image_size": 224, "patch_size": 16},
    "clip_vision_model": {"hidden_size": 768, "num_hidden_layers": 12,
                          "num_attention_heads": 12,
                          "intermediate_size": 3072, "image_size": 224,
                          "patch_size": 32},
    "resnet": {"embedding_size": 64, "depths": [3, 4, 6, 3],
               "layer_type": "bottleneck"},
    "swin": {"embed_dim": 96, "depths": [2, 2, 6, 2],
             "num_heads": [3, 6, 12, 24], "window_size": 7,
             "layer_norm_eps": 1e-5},
    "dinov2": {"hidden_size": 768, "num_hidden_layers": 12,
               "num_attention_heads": 12, "mlp_ratio": 4, "patch_size": 14,
               "layerscale_value": 1.0},
    "deberta-v2": {"vocab_size": 128100, "hidden_size": 1536,
                   "num_hidden_layers": 24, "num_attention_heads": 24,
                   "intermediate_size": 6144,
                   "position_biased_input": True},
}
CONFIG_DEFAULTS["phobert"] = CONFIG_DEFAULTS["roberta"]


def hub_cache_dir() -> Path:
    """The local HF hub cache: $HF_HUB_CACHE, else $HF_HOME/hub, else
    ~/.cache/huggingface/hub."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"]).expanduser()
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]).expanduser() / "hub"
    return Path("~/.cache/huggingface/hub").expanduser()


def resolve_model_dir(name_or_path: str | os.PathLike) -> Path:
    """A model directory, or the cached snapshot of hub name ``org/name``
    (its ``refs/main`` revision); ``OSError`` if neither exists."""
    path = Path(name_or_path).expanduser()
    if path.is_dir():
        if not (path / CONFIG_NAME).is_file():
            raise OSError(f"{path} has no {CONFIG_NAME}")
        return path
    name = str(name_or_path)
    repo = hub_cache_dir() / ("models--" + name.replace("/", "--"))
    ref = repo / "refs" / "main"
    if ref.is_file():
        snap = repo / "snapshots" / ref.read_text().strip()
        if (snap / CONFIG_NAME).is_file():
            return snap
    raise OSError(
        f"'{name}' is neither a local model directory nor a model in the "
        f"local Hugging Face cache ({hub_cache_dir()}); nothing is "
        f"downloaded: save it there (or to a directory) first")


def read_config(model_dir: str | os.PathLike) -> dict:
    """config.json, with the architecture's defaults for the fields the
    converters read; a ``clip`` model's ``vision_config`` gets the vision
    tower's."""
    with open(Path(model_dir) / CONFIG_NAME, encoding="utf-8") as f:
        cfg = json.load(f)
    mt = cfg.get("model_type", "")
    cfg = {**CONFIG_DEFAULTS.get(mt, {}), **cfg}
    if mt == "clip":
        cfg["vision_config"] = {**CONFIG_DEFAULTS["clip_vision_model"],
                                **(cfg.get("vision_config") or {})}
    return cfg


def read_safetensors(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFE_DTYPES:
            raise ValueError(f"{path}: tensor '{name}' has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"take")
        dtype = _SAFE_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        if end == begin:
            t = torch.empty(0, dtype=dtype)
        elif begin % size:
            # a tensor the header did not align: its own aligned copy
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, offset=begin,
                                 count=(end - begin) // size)
        out[name] = t.reshape(shape)
    return out


def read_torch_bin(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def read_weights(model_dir: str | os.PathLike) -> dict[str, torch.Tensor]:
    """The directory's tensors by their saved key names."""
    d = Path(model_dir)
    for single, index, read in ((SAFE_WEIGHTS, SAFE_INDEX, read_safetensors),
                                (TORCH_WEIGHTS, TORCH_INDEX, read_torch_bin)):
        if (d / single).is_file():
            return read(d / single)
        if (d / index).is_file():
            with open(d / index, encoding="utf-8") as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            out = {}
            for shard in shards:
                out.update(read(d / shard))
            return out
    raise OSError(f"{d} holds none of {SAFE_WEIGHTS}, {SAFE_INDEX}, "
                  f"{TORCH_WEIGHTS}, {TORCH_INDEX}")


class HFStateDict(Mapping):
    """A checkpoint's tensors by the base model's key names: the prefix
    stripped, tied keys resolved, a missing key a ``KeyError`` that names
    it and the checkpoint."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], model_type: str,
                 source: str = ""):
        prefix = BASE_PREFIX.get(model_type, "")
        strip = bool(prefix) and any(k.startswith(prefix + ".")
                                     for k in tensors)
        self._tensors = {}
        for key, t in tensors.items():
            if strip and key.startswith(prefix + "."):
                key = key[len(prefix) + 1:]
            self._tensors[key] = t
        self._tied = {}
        for group in TIED.get(model_type, ()):
            present = [k for k in group if k in self._tensors]
            for k in group:
                if k not in self._tensors and present:
                    self._tied[k] = present[0]
        self.model_type = model_type
        self.source = source

    def __getitem__(self, key: str) -> torch.Tensor:
        if key in self._tensors:
            return self._tensors[key]
        if key in self._tied:
            return self._tensors[self._tied[key]]
        raise KeyError(f"checkpoint {self.source or '(in memory)'} has no "
                       f"tensor '{key}', which the {self.model_type} "
                       f"converter needs (AutoModel would initialise it at "
                       f"random; the port refuses)")

    def __iter__(self):
        return iter([*self._tensors, *self._tied])

    def __len__(self) -> int:
        return len(self._tensors) + len(self._tied)


def load_hf_checkpoint(name_or_path: str | os.PathLike
                       ) -> tuple[dict, HFStateDict]:
    """(config dict, state dict) of a local HF model directory or a model
    in the local HF cache."""
    d = resolve_model_dir(name_or_path)
    cfg = read_config(d)
    return cfg, HFStateDict(read_weights(d), cfg.get("model_type", ""),
                            str(d))
