"""Forward and forward + backward of each tower of the flagship alone
(counterpart of tools/profile_towers.py).

    python3 -m vivqa_tpu_torch.tools.profile_towers --tower visual
        [--batch 128] [--steps 20] [--eval] [--nomask] [--device cpu]

Towers, at the JAX tool's configs (tools/profile_towers.py:54-169):

  visual  the CLIP-style ViT-B/32 (224 px, patch 32, 768 wide, 12 layers)
  text    the PhoBERT-style text encoder (64,001 tokens, 64 long, 768
          wide, 12 layers); ``--nomask`` gives it no attention mask
  embed   the 64,001 x 768 token table alone (``ops/embedding.py``)
  trunk   12 bare ``EncoderLayer``s (12 heads, d_ff 3,072, dropout 0.1)
          on (B, 64, 768), under an all-ones padding mask unless
          ``--nomask``
  fusion  4 + 4 MCAN (512 wide, 8 heads) + a 4-expert noisy top-2 MoE
          (hidden 1,024) + the answer head (1,000 answers) on random
          tower outputs (49 visual and 64 text tokens)

Each tower's loss is the JAX tool's: the mean square of the pooled
output (visual, text), of the embeddings or of the trunk's output, and
for the fusion the mean square of the logits + 0.01 x the router aux
loss. Both passes are timed by ``time_chained`` over ``--steps`` calls
(CUDA events); on a card each is timed again under torch.profiler, whose
summed kernel ms over that same window (``busy_ms``, beside
``profiled_window_ms``) give the idle share.
Prints the JAX tool's lines (forward, forward + backward and the
backward/forward ratio), then one JSON line. Dropout is on unless
``--eval``. The JAX tool's ``--threefry`` (a JAX PRNG implementation) has
no counterpart. ``--tower all`` runs the five in turn.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.device import card_line, resolve_device
from vivqa_tpu_torch.models.config import (AnswerHeadConfig, FusionConfig,
                                           TextEncoderConfig,
                                           VisualEncoderConfig)
from vivqa_tpu_torch.models.encoders import (create_text_encoder,
                                             create_visual_encoder)
from vivqa_tpu_torch.models.fusion import create_fusion
from vivqa_tpu_torch.models.heads import AnswerHead
from vivqa_tpu_torch.models.layers import (DropoutRNG, EncoderLayer,
                                           init_weights, make_attention_mask,
                                           to_dtype)
from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                               RouterConfig)
from vivqa_tpu_torch.models.moe.layer import create_moe_layer
from vivqa_tpu_torch.ops import flash_attention as fa
from vivqa_tpu_torch.ops.embedding import Embed
from vivqa_tpu_torch.utils.profiling import profiled_window, time_chained

TOWERS = ("visual", "text", "embed", "trunk", "fusion")
AUX_WEIGHT = 0.01           # tools/profile_towers.py:168


@dataclasses.dataclass(frozen=True)
class TowerSizes:
    """The widths and depths of the towers: the JAX tool's by default;
    tests build them small."""
    image_size: int = 224
    patch_size: int = 32
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    d_ff: int = 3072
    vocab: int = 64001
    text_len: int = 64
    fusion_hidden: int = 512
    fusion_heads: int = 8
    fusion_layers: int = 4
    experts: int = 4
    expert_hidden: int = 1024
    answers: int = 1000

    @property
    def visual_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class Trunk(nn.Module):
    """``layers`` bare encoder layers, named ``l0``, ``l1``... as the JAX
    tool's ``Trunk``."""

    def __init__(self, sizes: TowerSizes, dtype: torch.dtype,
                 dropout: float = 0.1):
        super().__init__()
        self.n = sizes.layers
        for i in range(self.n):
            self.add_module(f"l{i}", EncoderLayer(
                sizes.hidden, sizes.heads, sizes.d_ff, dtype=dtype,
                dropout=dropout))

    def forward(self, x, mask=None, rng=None):
        for i in range(self.n):
            x = getattr(self, f"l{i}")(x, mask, rng)
        return x


class Fuse(nn.Module):
    """MCAN + the noisy top-2 MoE + the answer head, under the flax names
    of the JAX tool's ``Fuse`` (``fusion`` and ``moe`` from the JAX
    factories, the head's default name)."""

    def __init__(self, sizes: TowerSizes):
        super().__init__()
        self.fusion = create_fusion(
            FusionConfig(fusion_type="mcan", hidden_dim=sizes.fusion_hidden,
                         num_heads=sizes.fusion_heads,
                         num_layers=sizes.fusion_layers),
            sizes.hidden, sizes.hidden)
        self.moe = create_moe_layer(MoEConfig(
            num_experts=sizes.experts, input_dim=sizes.fusion_hidden,
            expert=ExpertConfig(hidden_dim=sizes.expert_hidden),
            router=RouterConfig(router_type="noisy_topk", top_k=2)))
        self.AnswerHead_0 = AnswerHead(AnswerHeadConfig(), sizes.answers,
                                       sizes.fusion_hidden)

    def forward(self, visual: dict, text: dict, rng=None):
        out = self.fusion(visual, text, rng)
        tokens, aux = self.moe(out["tokens"], None, rng)
        logits = self.AnswerHead_0(tokens.mean(dim=1), rng)
        return logits, aux["aux_loss"]


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    return (x.float() ** 2).mean()


def build_tower(name: str, batch: int, device: torch.device,
                dtype: str = "bfloat16", deterministic: bool = False,
                nomask: bool = False, sizes: TowerSizes = TowerSizes(),
                seed: int = 0) -> tuple[nn.Module, tuple, Callable]:
    """(module, inputs, loss) of tower ``name``: ``loss(*inputs,
    generator=None) -> 0-d tensor``, the JAX tool's loss of the module
    on those inputs (a training forward when ``deterministic`` is False,
    drawing its dropout from ``generator``). The module's weights are
    drawn by flax's laws (seed ``seed``); the inputs by numpy as the JAX
    tool's are (``RandomState(0)`` pixels, ``RandomState(1)`` token ids;
    the trunk's and the fusion's normal inputs from ``RandomState(2)``
    and ``RandomState(3)``, where the JAX tool draws from its key).
    ``dtype`` is the towers' compute dtype (MCAN, the MoE's input and
    the head's hidden layer are bf16 in both packages whatever it is; the
    token table is f32, as the JAX tool's ``MatmulGradEmbed``)."""
    s, B = sizes, batch

    def tensor(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dt)

    ids = tensor(np.random.RandomState(1).randint(0, s.vocab - 1,
                                                  (B, s.text_len)),
                 torch.int64)
    ones = torch.ones(B, s.text_len, dtype=torch.int64, device=device)
    # built where it runs: nn.Linear's own draw, before flax's law draws
    # again, takes seconds for the text tower on the host
    with device:
        if name == "visual":
            module = create_visual_encoder(VisualEncoderConfig(
                backbone="clip", image_size=s.image_size,
                patch_size=s.patch_size, hidden_dim=s.hidden,
                num_layers=s.layers, num_heads=s.heads, dtype=dtype))
            inputs = (tensor(np.random.RandomState(0).rand(
                B, s.image_size, s.image_size, 3)),)

            def run(px, rng):
                return _mean_square(module(px, rng)["pooled"])
        elif name == "text":
            module = create_text_encoder(TextEncoderConfig(
                backbone="phobert", vocab_size=s.vocab, hidden_dim=s.hidden,
                num_layers=s.layers, num_heads=s.heads, max_length=s.text_len,
                dtype=dtype))
            mask = None if nomask else ones
            inputs = (ids,)

            def run(ids_in, rng):
                return _mean_square(module(ids_in, mask, rng)["pooled"])
        elif name == "embed":
            module = Embed(s.vocab, s.hidden, torch.float32)
            inputs = (ids,)

            def run(ids_in, rng):
                return _mean_square(module(ids_in))
        elif name == "trunk":
            module = Trunk(s, to_dtype(dtype))
            x = tensor(np.random.RandomState(2).standard_normal(
                (B, s.text_len, s.hidden)))
            mask = None if nomask else make_attention_mask(ones, ones)
            inputs = (x,)

            def run(x_in, rng):
                return _mean_square(module(x_in, mask, rng))
        elif name == "fusion":
            module = Fuse(s)
            rs = np.random.RandomState(3)
            n_v = s.visual_tokens
            v_tokens = tensor(rs.standard_normal((B, n_v, s.hidden)))
            v_pooled = tensor(rs.standard_normal((B, s.hidden)))
            t_pooled = tensor(rs.standard_normal((B, s.hidden)))
            t_tokens = tensor(rs.standard_normal((B, s.text_len, s.hidden)))
            inputs = (v_tokens, v_pooled, t_tokens, t_pooled, ones)

            def run(tokens, pooled, t_tokens, t_pooled, t_mask, rng):
                logits, aux = module(
                    {"pooled": pooled, "tokens": tokens},
                    {"pooled": t_pooled, "tokens": t_tokens, "mask": t_mask},
                    rng)
                return _mean_square(logits) + AUX_WEIGHT * aux
        else:
            raise ValueError(f"unknown tower '{name}' (choices: {TOWERS})")
    module = module.to(device)
    init_weights(module, torch.Generator(device=device).manual_seed(seed))
    module.train(not deterministic)

    def loss(*args, generator: Optional[torch.Generator] = None):
        rng = None
        if not deterministic:
            if generator is None:
                raise ValueError("a training forward needs a generator")
            rng = DropoutRNG(generator)
        return run(*args, rng)
    return module, inputs, loss


def profile_tower(name: str, batch: int, steps: int, device: torch.device,
                  deterministic: bool = False, nomask: bool = False,
                  sizes: TowerSizes = TowerSizes(), seed: int = 0) -> dict:
    """The tower's forward and forward + backward: wall ms (events over
    ``steps`` chained calls), the profiled window's ms and its busy ms,
    the idle share, launches a call."""
    module, inputs, loss = build_tower(name, batch, device,
                                       deterministic=deterministic,
                                       nomask=nomask, sizes=sizes, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = [p for p in module.parameters() if p.requires_grad]

    def fwd(*args):
        return loss(*args, generator=gen)

    def fwd_bwd(*args):
        with torch.enable_grad():
            value = loss(*args, generator=gen)
            torch.autograd.grad(value, params, allow_unused=True)
        return value.detach()

    out = {}
    for label, fn in (("forward", fwd), ("fwd_bwd", fwd_bwd)):
        fa.reset_launch_counts()
        wall = time_chained(fn, inputs, steps) * 1e3
        launches = {k: n / (steps + 1) for k, n in fa.launch_counts.items()}
        window = busy = None
        if device.type == "cuda":
            window, busy = profiled_window(
                lambda within: time_chained(fn, inputs, steps, within) * 1e3,
                steps)
        out[label] = {"wall_ms": wall, "busy_ms": busy,
                      "profiled_window_ms": window,
                      "idle_share": None if busy is None
                      else 1 - busy / window,
                      "launches_per_call": launches}
    f, fb = out["forward"]["wall_ms"], out["fwd_bwd"]["wall_ms"]
    out["bwd_fwd_ratio"] = (fb - f) / f
    out["parameters"] = sum(p.numel() for p in params)
    return out


def main(argv: Optional[Sequence[str]] = None,
         sizes: TowerSizes = TowerSizes()) -> dict:
    """The CLI; ``sizes`` (from Python only) replaces the JAX tool's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tower", required=True, choices=TOWERS + ("all",))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--eval", action="store_true",
                    help="deterministic mode (no dropout)")
    ap.add_argument("--nomask", action="store_true",
                    help="text and trunk: no attention mask")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    towers = TOWERS if args.tower == "all" else (args.tower,)
    results = {}
    for name in towers:
        print(f"tower={name} B={args.batch} det={args.eval} on {kind}",
              flush=True)
        r = profile_tower(name, args.batch, args.steps, device,
                          deterministic=args.eval, nomask=args.nomask,
                          sizes=sizes)
        print(f"forward : {r['forward']['wall_ms']:8.2f} ms", flush=True)
        print(f"fwd+bwd : {r['fwd_bwd']['wall_ms']:8.2f} ms   "
              f"(bwd/fwd ratio {r['bwd_fwd_ratio']:.1f}x)", flush=True)
        results[name] = r
    line = {"tool": "profile_towers", "device": kind,
            "card": card_line() if on_card else None, "batch": args.batch,
            "steps": args.steps, "deterministic": args.eval,
            "nomask": args.nomask, "towers": results}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
