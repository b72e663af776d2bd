"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for CUDA on a host without it raises: nothing falls back to the CPU
behind the caller's back.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but none is available; pass "
                "device='cpu' to run the plain path on the CPU")
        # f32 products and convolutions in full f32, as the reference
        # computes them; cuDNN would otherwise run the f32 patch conv in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]
