"""Attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of vivqa_tpu/ops/flash_attention.py. ``flash_attention`` takes
the JAX layout ``(B, H, L, D)`` and dispatches on the device of its
inputs:

- CPU tensors go to ``attention_reference``, the plain PyTorch version:
  ``_xla_attention`` (f32 logits, -1e30 masking, f32 softmax, probabilities
  cast to v's dtype before P.V) with flax's masking rule, so a row whose
  keys are all masked is the uniform average over its keys, not NaN;
- CUDA tensors go to ``flash_attention_cuda``, the hand-written forward
  kernel in ``csrc/flash_attn_fwd.cu`` (replacing the Pallas
  ``_flash_kernel``), which launches or raises. There is no fallback.

Unlike the TPU gate (causal or Lk >= 1024, no mask) every call, masked or
not and of any length, takes the kernel on the card: at the serving
shapes (L <= 64, padding masks) it carries all of the model's attention.

The backward kernels (``_flash_kernel_lse``, ``_flash_bwd_dkv_kernel``,
``_flash_bwd_dq_kernel``) belong to the training path and are not ported
yet; see ROADMAP.md, Queue B.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30

# Launches of each kernel of this module. ``flash_attention_cuda`` adds one
# per kernel launch and nothing else does, so a run can show that its
# attention went through the kernel.
launch_counts = {"flash_attn_fwd": 0}

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain version: (B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D).

    ``mask`` is boolean and broadcasts to (B, H, Lq, Lk); True keeps a key.
    The causal diagonal sits at the end of the keys (``tril(Lk - Lq)``).
    """
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d)
    if causal:
        Lq, Lk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(Lq, Lk, dtype=torch.bool,
                        device=q.device).tril(Lk - Lq)
        logits = torch.where(cm, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _check_cuda_inputs(q, k, v, mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device} (q on {q.device})")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous over D "
                             f"(strides {t.stride()})")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype} "
                         f"(kernel takes {tuple(_DTYPE_CODES)})")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (kernel takes "
                         f"{HEAD_DIMS})")
    if Lq == 0 or Lk == 0 or B * H == 0:
        raise ValueError(f"empty attention q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535 rows")
    if mask is None:
        return (0, 0, 0)
    if mask.dtype != torch.bool or mask.device != q.device:
        raise ValueError(f"mask must be bool on {q.device}, got "
                         f"{mask.dtype} on {mask.device}")
    if mask.dim() != 4 or mask.shape[1] != 1:
        raise ValueError(f"mask must be (B, 1, Lq, Lk) or broadcast to it, "
                         f"got {tuple(mask.shape)}")
    m = mask.expand(B, 1, Lq, Lk)       # broadcast dims get stride 0
    return (m.stride(0), m.stride(2), m.stride(3))


def _library():
    from vivqa_tpu_torch.ops import cuda_build
    lib = cuda_build.load("flash_attn_fwd")
    fn = lib.vivqa_flash_attn_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         causal: bool = False) -> torch.Tensor:
    """Launch the Hopper forward kernel; raise on what it does not take.

    Inputs need a unit stride over D only, so views of (B, L, H, D)
    projections are read in place. The output is allocated as
    (B, Lq, H, D) and returned as its (B, H, Lq, D) view, so the caller's
    merge of the heads is free.
    """
    m_strides = _check_cuda_inputs(q, k, v, mask)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 15)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2), *m_strides)
    # 16-byte vector loads need every row of q, k and v to start aligned
    vec = 16 // q.element_size()
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % vec == 0 for st in t.stride()[:3])
                  for t in (q, k, v))
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 _DTYPE_CODES[q.dtype], D, B, H, Lq, Lk, strides,
                 int(causal), int(aligned), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: error {err}")
    launch_counts["flash_attn_fwd"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D).

    CPU tensors take the plain version; CUDA tensors take the kernel.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, mask, causal)
    raise ValueError(f"no attention path for device {q.device}")
