"""Attention: hand-written CUDA kernels, their plain versions, and the
gradient.

Counterpart of vivqa_tpu/ops/flash_attention.py. ``flash_attention`` takes
the JAX layout ``(B, H, L, D)`` and dispatches on the device of its
inputs and on whether a gradient is needed:

- with no gradient and no dropout (``torch.no_grad()``, inference mode,
  serving), CPU tensors go to ``attention_reference``, the plain version
  (``_xla_attention``: f32 logits, -1e30 masking, f32 softmax,
  probabilities cast to v's dtype before P.V, flax's rule that a row
  whose keys are all masked is the uniform average over its keys), and
  CUDA tensors to ``flash_attention_cuda``, the forward kernel
  (``csrc/flash_attn_fwd.cu``, replacing the Pallas ``_flash_kernel``);
- otherwise ``FlashAttention``, the counterpart of the custom VJP
  ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``. On CUDA tensors its
  forward launches the forward-with-stats kernel (``_flash_kernel_lse``)
  and its backward, in bf16 and f16, the one-pass backward kernel
  (``csrc/flash_attn_bwd.cu``, replacing both ``_flash_bwd_dq_kernel``
  and ``_flash_bwd_dkv_kernel``), in f32 the dQ kernel then the dK/dV
  kernel; on CPU tensors it runs their plain versions,
  ``attention_forward_lse_reference`` and ``attention_backward_reference``,
  which follow the Pallas math.

A CUDA tensor launches a kernel or raises; there is no fallback. Unlike
the TPU gate (causal or Lk >= 1024, no mask) every call, masked or not and
of any length, takes the kernels on the card.

Attention-probability dropout (flax's ``broadcast_dropout``: one keep mask
of shape (Lq, Lk) per call, shared by every batch row and head) lives in
the kernels, which never hold the probabilities in memory. The keep bit of
(q, k) is a counter-based hash of the call's 32-bit ``dropout_key``, q and
k; the plain versions compute the same bits with torch integer ops
(``dropout_keep_mask``), so kernel and plain version agree on the mask bit
for bit. A kept probability is multiplied by 1 / (1 - rate) in f32 after
normalisation and before P.V.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30

# Launches of each kernel of this module. Each wrapper adds one per kernel
# launch and nothing else does, so a run can show that its attention went
# through the kernels. flash_attn_fwd and flash_attn_fwd_lse count the
# forward kernels (every form), flash_attn_fwd_merge the merge that the
# forward's long form adds where it splits the keys (either entry); the
# bf16/f16 backward is flash_attn_bwd (and, in its long form, the dQ sum);
# flash_attn_bwd_dq and flash_attn_bwd_dkv count f32 backward launches only.
launch_counts = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 0,
                 "flash_attn_fwd_merge": 0,
                 "flash_attn_bwd": 0, "flash_attn_bwd_sum": 0,
                 "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}

# head dims the kernels are built for: 64 on every flagship path; 32 in
# the demo-size models of the convergence benches (width 128, 4 heads)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# What each launch count's kernel is called on the device (a part of the
# names torch.profiler reports; each bf16/f16 forward form's serving and
# training kernels are named *_serve_* and *_train_*, so no part is a part
# of another's names; the f32 forward kernel is none of these), and parts
# of what a library's attention kernels are called (PyTorch's flash and
# memory-efficient SDPA, cuDNN's fused attention); no kernel of this
# module's names holds one of these.
DEVICE_KERNEL_NAMES = {"flash_attn_fwd": "flash_attn_fwd_serve",
                       "flash_attn_fwd_lse": "flash_attn_fwd_train",
                       "flash_attn_fwd_merge": "flash_attn_fwd_merge",
                       "flash_attn_bwd": "flash_attn_bwd_kernel",
                       "flash_attn_bwd_sum": "flash_attn_bwd_sum_kernel",
                       "flash_attn_bwd_dq": "flash_attn_bwd_dq",
                       "flash_attn_bwd_dkv": "flash_attn_bwd_dkv"}
LIBRARY_ATTENTION_NAMES = ("fmha", "flash_fwd", "flash_bwd", "sdpa",
                           "attention")


def attention_kernel_counts(kernels: dict) -> dict:
    """{launch count name: launches} of a profile's ``kernels`` ({device
    kernel name: launches}), and under ``library`` the sorted names of any
    library attention kernel among them."""
    counts = {name: sum(c for n, c in kernels.items() if part in n)
              for name, part in DEVICE_KERNEL_NAMES.items()}
    counts["library"] = sorted(n[:90] for n in kernels if any(
        p in n.lower() for p in LIBRARY_ATTENTION_NAMES))
    return counts


# -- attention dropout: the keep hash ---------------------------------------
_M32 = 0xFFFFFFFF


def _mix32(x: int) -> int:
    """The kernels' ``mix32`` ("lowbias32") on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding 32-bit values, split so
    that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_key(seed: int, offset: int) -> int:
    """The 32-bit key of one attention call's keep mask, from a 64-bit
    seed and the call's offset (its index within a forward)."""
    return _mix32(_mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))
                  ^ (offset & _M32))


def dropout_threshold(rate: float) -> int:
    """Key (q, k) is kept iff its hash >= floor(rate * 2**32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return min(_M32, int(rate * 2 ** 32))


def dropout_keep_mask(Lq: int, Lk: int, rate: float, key: int,
                      device=None) -> torch.Tensor:
    """(Lq, Lk) bool: the keep bits the kernels generate for this call."""
    rows = _mix32_t(torch.arange(Lq, dtype=torch.int64, device=device)
                    ^ (key & _M32))
    cols = torch.arange(Lk, dtype=torch.int64, device=device)
    return _mix32_t(rows[:, None] ^ cols[None, :]) >= dropout_threshold(rate)


def dropout_multiplier(Lq: int, Lk: int, rate: float, key: int, dtype,
                       device=None) -> torch.Tensor:
    """(Lq, Lk): keep / (1 - rate), the factor applied to p."""
    keep = dropout_keep_mask(Lq, Lk, rate, key, device)
    return keep.to(dtype) * torch.tensor(1.0 / (1.0 - rate), dtype=dtype)


# -- plain versions ----------------------------------------------------------
def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _allowed(mask: Optional[torch.Tensor], causal: bool, Lq: int, Lk: int,
             device) -> Optional[torch.Tensor]:
    """Boolean keep mask broadcastable to (B, H, Lq, Lk), or None."""
    allowed = mask
    if causal:
        cm = torch.ones(Lq, Lk, dtype=torch.bool, device=device).tril(Lk - Lq)
        allowed = cm if allowed is None else allowed & cm
    return allowed


def _masked_logits(q, k, mask, causal):
    acc = _acc_dtype(q)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc))
    logits = logits / math.sqrt(q.shape[-1])
    allowed = _allowed(mask, causal, q.shape[2], k.shape[2], q.device)
    if allowed is not None:
        logits = torch.where(allowed, logits, NEG_INF)
    return logits


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False, dropout_rate: float = 0.0,
                        dropout_key: int = 0) -> torch.Tensor:
    """Plain version: (B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D).

    ``mask`` is boolean and broadcasts to (B, H, Lq, Lk); True keeps a key.
    The causal diagonal sits at the end of the keys (``tril(Lk - Lq)``).
    Dropout multiplies the probabilities by ``dropout_multiplier``.
    """
    probs = torch.softmax(_masked_logits(q, k, mask, causal), dim=-1)
    if dropout_rate:
        probs = probs * dropout_multiplier(q.shape[2], k.shape[2],
                                           dropout_rate, dropout_key,
                                           probs.dtype, q.device)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def attention_forward_lse_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, causal: bool = False,
        dropout_rate: float = 0.0, dropout_key: int = 0):
    """Plain version of the training forward (``_flash_kernel_lse``):
    ``(o, m, l)`` with o as ``attention_reference`` and the per-row f32
    stats m = max of the masked logits, l = sum exp(logits - m), kept
    separate (a fully masked row has m = -1e30 and l = Lk)."""
    logits = _masked_logits(q, k, mask, causal)
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate:
        probs = probs * dropout_multiplier(q.shape[2], k.shape[2],
                                           dropout_rate, dropout_key,
                                           probs.dtype, q.device)
    o = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return o, m, l


def _bwd_probs(q, k, m, l, mask, causal):
    """p = exp(s - m) / l from the forward's stats, and the allowed mask."""
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc))
    s = s / math.sqrt(q.shape[-1])
    allowed = _allowed(mask, causal, q.shape[2], k.shape[2], q.device)
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    return torch.exp(s - m.to(acc)[..., None]) / l.to(acc)[..., None], allowed


def _bwd_ds(p, allowed, v, do, delta, z):
    """dS = p (dP - delta), dP = (dO V^T) z; 0 where masked."""
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(p.dtype), v.to(p.dtype))
    if z is not None:
        dp = dp * z
    ds = p * (dp - delta[..., None])
    return ds if allowed is None else torch.where(allowed, ds, 0.0)


def _bwd_z(q, k, rate, key, dtype):
    if not rate:
        return None
    return dropout_multiplier(q.shape[2], k.shape[2], rate, key, dtype,
                              q.device)


def attention_bwd_dq_reference(q, k, v, o, m, l, do, mask=None,
                               causal=False, dropout_rate=0.0,
                               dropout_key=0):
    """Plain version of the dQ kernel: (dq, delta), with
    delta = rowsum(dO * O) in f32 (f64 for f64 inputs)."""
    acc = _acc_dtype(q)
    p, allowed = _bwd_probs(q, k, m, l, mask, causal)
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1)
    ds = _bwd_ds(p, allowed, v, do, delta,
                 _bwd_z(q, k, dropout_rate, dropout_key, acc))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc)) / math.sqrt(
        q.shape[-1])
    return dq.to(q.dtype), delta


def attention_bwd_dkv_reference(q, k, v, m, l, do, delta, mask=None,
                                causal=False, dropout_rate=0.0,
                                dropout_key=0):
    """Plain version of the dK/dV kernel: (dk, dv)."""
    acc = _acc_dtype(q)
    p, allowed = _bwd_probs(q, k, m, l, mask, causal)
    z = _bwd_z(q, k, dropout_rate, dropout_key, acc)
    pz = p if z is None else p * z
    dv = torch.einsum("bhqk,bhqd->bhkd", pz, do.to(acc))
    ds = _bwd_ds(p, allowed, v, do, delta, z)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) / math.sqrt(
        q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        m: torch.Tensor, l: torch.Tensor, do: torch.Tensor,
        mask: Optional[torch.Tensor] = None, causal: bool = False,
        dropout_rate: float = 0.0, dropout_key: int = 0):
    """Plain version of the backward (``_flash_backward``'s two kernels),
    whole-matrix: p = exp(s - m) / l from the forward's stats,
    delta = rowsum(dO * O), dV = (p z)^T dO, dP = (dO V^T) z,
    dS = p (dP - delta) and 0 where masked, dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D); z is the dropout multiplier (1 without).
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    dq, delta = attention_bwd_dq_reference(q, k, v, o, m, l, do, mask,
                                           causal, dropout_rate, dropout_key)
    dk, dv = attention_bwd_dkv_reference(q, k, v, m, l, do, delta, mask,
                                         causal, dropout_rate, dropout_key)
    return dq, dk, dv


# -- the CUDA kernels --------------------------------------------------------
def _check_operand(name, t, q):
    if t.device.type != "cuda" or t.device != q.device:
        raise ValueError(f"{name} must be on q's CUDA device, got "
                         f"{t.device} (q on {q.device})")
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, H, L, D), got {tuple(t.shape)}")
    if t.dtype != q.dtype:
        raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous over D "
                         f"(strides {t.stride()})")


def _check_cuda_inputs(q, k, v, mask):
    """Validate q, k, v and the mask; return the mask's (b, q, k) strides."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
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


def _aligned(*tensors) -> bool:
    """16-byte vector loads need every row of every operand aligned."""
    vec = 16 // tensors[0].element_size()
    return all(t.data_ptr() % 16 == 0
               and all(st % vec == 0 for st in t.stride()[:3])
               for t in tensors)


def _blh(t):
    return (t.stride(0), t.stride(1), t.stride(2))


def _heads_last(B, L, H, D, like):
    """(B, L, H, D) storage returned as its (B, H, L, D) view, so the
    caller's merge or split of the heads is free."""
    return torch.empty((B, L, H, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _dropout_args(rate: float, key: Optional[int]):
    if not rate:
        return 0, 0, 0, 1.0
    if key is None:
        raise ValueError("attention dropout needs a dropout_key")
    return 1, dropout_threshold(rate), key & _M32, 1.0 / (1.0 - rate)


_PLAN_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p]   # form, tiles a split
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                ctypes.c_float] + _PLAN_ARGS)
_FWD_LSE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_uint, ctypes.c_float] + _PLAN_ARGS)
_BWD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                ctypes.c_float, ctypes.c_void_p])
_BWD_FUSED_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                      ctypes.c_void_p])


def _entry(source: str, symbol: str, argtypes):
    from vivqa_tpu_torch.ops import cuda_build
    fn = getattr(cuda_build.load(source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(name, q, k, v, mask, causal, stats, dropout_rate=0.0,
                    dropout_key=None):
    """Launch ``name``'s forward kernel, in bf16 and f16 in the form
    ``forward_plan`` picks (the tile and long forms read q, k and v by TMA
    in place where their bases and strides meet its 16-byte rules, else
    from a contiguous copy; the long form's f32 partials are allocated
    here), in f32 the SIMT template; raise on what it does not take.
    Returns o (and m, l when ``stats``)."""
    m_strides = _check_cuda_inputs(q, k, v, mask)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    form, tiles_per_split, part, launches = 0, 0, None, 1
    if q.dtype != torch.float32:
        plan = forward_plan(B, H, Lq, Lk, D, _sm_count(q.device))
        launches = plan["launches"]
        if plan["form"] != "decode":
            form = _KERNEL_FORMS[plan["query_tile"], plan["key_tile"]]
            tiles_per_split = plan["tiles_per_split"]
            q, k, v = (_tma_ready(t) for t in (q, k, v))
        if plan["scratch"] is not None:
            part = torch.empty(math.prod(plan["scratch"]), dtype=torch.float32,
                               device=q.device)
    out = _heads_last(B, Lq, H, D, q)
    strides = (ctypes.c_longlong * 15)(*_blh(q), *_blh(k), *_blh(v),
                                        *_blh(out), *m_strides)
    call = (_DTYPE_CODES[q.dtype], D, B, H, Lq, Lk, strides, int(causal),
            int(_aligned(q, k, v)), 1.0 / math.sqrt(D))
    plan_args = (form, tiles_per_split, _stream(q))
    pointers = (None if part is None else part.data_ptr(),
                None if mask is None else mask.data_ptr())
    with torch.cuda.device(q.device):
        if stats:
            m = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
            fn = _entry("flash_attn_fwd", "vivqa_flash_attn_fwd_lse",
                        _FWD_LSE_ARGS)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     m.data_ptr(), l.data_ptr(), *pointers, *call,
                     *_dropout_args(dropout_rate, dropout_key), *plan_args)
        else:
            fn = _entry("flash_attn_fwd", "vivqa_flash_attn_fwd", _FWD_ARGS)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     *pointers, *call, *plan_args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")
    launch_counts[name] += 1
    if launches == 2:
        launch_counts["flash_attn_fwd_merge"] += 1
    return (out, m, l) if stats else out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         causal: bool = False) -> torch.Tensor:
    """Launch the Hopper forward kernel; raise on what it does not take.

    Inputs need a unit stride over D only, so views of (B, L, H, D)
    projections are read in place (or, in the tile and long forms, copied
    where TMA's 16-byte rules fail). The output is allocated as
    (B, Lq, H, D) and returned as its (B, H, Lq, D) view. bf16 and f16
    take the form ``forward_plan`` picks; f32 runs the SIMT template.
    """
    return _launch_forward("flash_attn_fwd", q, k, v, mask, causal, False)


def flash_attention_fwd_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 causal: bool = False,
                                 dropout_rate: float = 0.0,
                                 dropout_key: Optional[int] = None):
    """Launch the training forward kernel: ``(o, m, l)``, o as
    ``flash_attention_cuda`` (with dropout), m and l (B, H, Lq) f32."""
    return _launch_forward("flash_attn_fwd_lse", q, k, v, mask, causal, True,
                           dropout_rate, dropout_key)


def _check_bwd_inputs(q, k, v, o, m, l, do, mask):
    """As _check_cuda_inputs, plus o, dO and the stats; returns dO with a
    unit stride over D (copied only if it has none)."""
    m_strides = _check_cuda_inputs(q, k, v, mask)
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_operand("dO", do, q)
    if o is not None:
        _check_operand("o", o, q)
    if do.shape != q.shape or (o is not None and o.shape != q.shape):
        raise ValueError(f"o and dO {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    for name, t in (("m", m), ("l", l)):
        if t.dtype != torch.float32 or t.shape != q.shape[:3] \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous f32 (B, H, Lq) on "
                             f"{q.device}")
    return m_strides, do


def _launch_bwd(name, q, k, v, o, m, l, do, delta, dq, dk, dv, mask,
                m_strides, causal, dropout_rate, dropout_key):
    B, H, Lq, D = q.shape
    dummy = q           # the pointers and strides a kernel does not use
    o, dq, dk, dv = (dummy if t is None else t for t in (o, dq, dk, dv))
    strides = (ctypes.c_longlong * 27)(
        *_blh(q), *_blh(k), *_blh(v), *_blh(o), *_blh(do), *_blh(dq),
        *_blh(dk), *_blh(dv), *m_strides)
    fn = _entry(name, f"vivqa_{name}", _BWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 _DTYPE_CODES[q.dtype], D, B, H, Lq, k.shape[2], strides,
                 int(causal), int(_aligned(q, k, v, do)), 1.0 / math.sqrt(D),
                 *_dropout_args(dropout_rate, dropout_key), _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")
    launch_counts[name] += 1


def _check_f32(q):
    if q.dtype != torch.float32:
        raise ValueError(f"the dQ and dK/dV kernels take float32, got "
                         f"{q.dtype} (bf16 and f16 take "
                         f"flash_attention_bwd_fused_cuda)")


def flash_attention_bwd_dq_cuda(q, k, v, o, m, l, do, mask=None,
                                causal=False, dropout_rate=0.0,
                                dropout_key=None):
    """Launch the f32 dQ kernel: (dq, delta). dq is allocated as (B, Lq, H,
    D) and returned as its (B, H, Lq, D) view; delta = rowsum(dO * O),
    (B, H, Lq) f32, feeds the dK/dV kernel."""
    m_strides, do = _check_bwd_inputs(q, k, v, o, m, l, do, mask)
    _check_f32(q)
    B, H, Lq, D = q.shape
    dq = _heads_last(B, Lq, H, D, q)
    delta = torch.empty_like(m)
    _launch_bwd("flash_attn_bwd_dq", q, k, v, o, m, l, do, delta, dq, None,
                None, mask, m_strides, causal, dropout_rate, dropout_key)
    return dq, delta


def flash_attention_bwd_dkv_cuda(q, k, v, m, l, do, delta, mask=None,
                                 causal=False, dropout_rate=0.0,
                                 dropout_key=None):
    """Launch the f32 dK/dV kernel: (dk, dv), each allocated as (B, Lk, H,
    D) and returned as its (B, H, Lk, D) view."""
    m_strides, do = _check_bwd_inputs(q, k, v, None, m, l, do, mask)
    _check_f32(q)
    if delta.dtype != torch.float32 or delta.shape != m.shape \
            or not delta.is_contiguous() or delta.device != q.device:
        raise ValueError("delta must be contiguous f32 (B, H, Lq)")
    B, H, Lk, D = k.shape
    dk = _heads_last(B, Lk, H, D, k)
    dv = _heads_last(B, Lk, H, D, v)
    _launch_bwd("flash_attn_bwd_dkv", q, k, v, None, m, l, do, delta, None,
                dk, dv, mask, m_strides, causal, dropout_rate, dropout_key)
    return dk, dv


# The bf16/f16 forward's forms (f32 runs the SIMT template, one launch):
# a call of at most DECODE_MAX_QUERIES queries takes the decode form, a
# unit per (b, h) on the CUDA cores; any other call takes units of
# (b, h, query tile) on wgmma: the tile form while its keys fit
# TILE_MAX_KEYS, else the long form. A unit is 64 queries over 64-key
# tiles, or over one 32-key tile where the keys fit NARROW_MAX_KEYS; over
# more than 64 queries and more than WIDE_MIN_KEYS keys 128 queries (two
# consumer warpgroups sharing each K/V tile) over 128-key tiles (64 at D =
# 128).
# Where a long-form call has fewer units than half the card's SMs, its
# keys are split over about twice as many units as SMs, whose f32
# partials a second kernel merges (two launches).
FWD_QUERY_TILE = 64
DECODE_MAX_QUERIES = 4
TILE_MAX_KEYS = 128
WIDE_MIN_KEYS = 64
NARROW_MAX_KEYS = 32
H100_SMS = 132
# the C entry's form of each (query tile, key tile), bf16/f16 (0: decode)
_KERNEL_FORMS = {(64, 64): 1, (128, 128): 2, (128, 64): 2, (64, 32): 3}


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def forward_plan(B: int, H: int, Lq: int, Lk: int, D: int,
                 sms: int = H100_SMS) -> dict:
    """How the bf16/f16 forward kernel takes a call on a card of ``sms``
    SMs: its ``form`` ("decode", "tile" or "long"), ``launches``,
    ``units``, ``query_tile`` and ``key_tile`` (queries a unit, keys a
    tile: None in the decode form), ``splits`` (key splits of each (b, h,
    query tile)) of ``tiles_per_split`` key tiles each, and the
    ``scratch`` shape of the long form's f32 partials where it splits,
    (splits, B, H, Lq, D + 2): each row's o, m and l (None without
    splits)."""
    if Lq <= DECODE_MAX_QUERIES:
        return {"form": "decode", "launches": 1, "units": B * H,
                "query_tile": None, "key_tile": None, "splits": 1,
                "tiles_per_split": None, "scratch": None}
    form = "tile" if Lk <= TILE_MAX_KEYS else "long"
    wide = Lq > FWD_QUERY_TILE and Lk > WIDE_MIN_KEYS
    query_tile = 2 * FWD_QUERY_TILE if wide else FWD_QUERY_TILE
    key_tile = (128 if wide and D <= 64 else 64 if wide or Lk > NARROW_MAX_KEYS
                else 32)
    n_kt = -(-Lk // key_tile)
    units = B * H * -(-Lq // query_tile)
    per_split = n_kt
    if form == "long" and 2 * units < sms:
        per_split = -(-n_kt // min(n_kt, -(-2 * sms // units)))
    splits = -(-n_kt // per_split)
    return {"form": form, "launches": 1 if splits == 1 else 2,
            "units": units * splits, "query_tile": query_tile,
            "key_tile": key_tile, "splits": splits,
            "tiles_per_split": per_split,
            "scratch": None if splits == 1 else (splits, B, H, Lq, D + 2)}


# The one-pass backward's units: a call whose Lq and Lk are both at most
# ONE_PASS_MAX takes one launch, a unit per (b, h) with one consumer
# warpgroup per 64-key tile; any other call the long form: a unit per
# (b, h, 64-key tile), dQ partials in an f32 scratch summed by a second
# kernel (two launches).
ONE_PASS_MAX = 128
BWD_KEY_TILE = 64


def backward_plan(B: int, H: int, Lq: int, Lk: int, D: int) -> dict:
    """How the one-pass backward kernel takes a call: its ``form``
    ("one_pass" or "long"), ``launches``, ``units``, ``key_tiles`` (64-key
    tiles a unit's consumer warpgroups take) and the f32 ``scratch`` shape
    of the long form's dQ partials (None in the one-pass form)."""
    n_kt = -(-Lk // BWD_KEY_TILE)
    if Lq <= ONE_PASS_MAX and Lk <= ONE_PASS_MAX:
        return {"form": "one_pass", "launches": 1, "units": B * H,
                "key_tiles": n_kt, "scratch": None}
    return {"form": "long", "launches": 2, "units": B * H * n_kt,
            "key_tiles": 1, "scratch": (n_kt, B, H, Lq, D)}


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where TMA's 16-byte rules fail: the base on
    16 bytes, every stepped (b, h, l) stride a multiple of 16 bytes."""
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st % vec == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
            if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd_fused_cuda(q, k, v, o, m, l, do, mask=None,
                                   causal=False, dropout_rate=0.0,
                                   dropout_key=None):
    """Launch the one-pass backward kernel (bf16, f16): (dq, dk, dv), each
    allocated as (B, L, H, D) and returned as its (B, H, L, D) view.

    q, k, v, o and dO are read by TMA in place where their bases and
    strides meet its 16-byte rules, else from a contiguous copy. The long
    form (``backward_plan``) allocates its f32 dQ partials here."""
    m_strides, do = _check_bwd_inputs(q, k, v, o, m, l, do, mask)
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the one-pass backward takes bfloat16 and float16, "
                         f"got {q.dtype} (float32 takes the dQ and dK/dV "
                         f"kernels)")
    q, k, v, o, do = (_tma_ready(t) for t in (q, k, v, o, do))
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    plan = backward_plan(B, H, Lq, Lk, D)
    long_form = plan["form"] == "long"
    dq = _heads_last(B, Lq, H, D, q)
    dk = _heads_last(B, Lk, H, D, k)
    dv = _heads_last(B, Lk, H, D, v)
    part = None
    if long_form:
        part = torch.empty(plan["scratch"], dtype=torch.float32,
                           device=q.device)
    strides = (ctypes.c_longlong * 27)(
        *_blh(q), *_blh(k), *_blh(v), *_blh(o), *_blh(do), *_blh(dq),
        *_blh(dk), *_blh(dv), *m_strides)
    fn = _entry("flash_attn_bwd", "vivqa_flash_attn_bwd", _BWD_FUSED_ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), m.data_ptr(), l.data_ptr(),
                 None if part is None else part.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 _DTYPE_CODES[q.dtype], D, B, H, Lq, Lk, strides,
                 int(causal), int(long_form), 1.0 / math.sqrt(D),
                 *_dropout_args(dropout_rate, dropout_key), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: error {err}")
    launch_counts["flash_attn_bwd"] += 1
    if long_form:
        launch_counts["flash_attn_bwd_sum"] += 1
    return dq, dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             m: torch.Tensor, l: torch.Tensor,
                             do: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             causal: bool = False, dropout_rate: float = 0.0,
                             dropout_key: Optional[int] = None):
    """The backward on the card: in bf16 and f16 the one-pass kernel, in
    f32 the dQ kernel (which also writes delta), then the dK/dV kernel;
    (dq, dk, dv) as (B, H, L, D) views of (B, L, H, D) storage.

    ``do`` may have any strides over (b, h, l); one that is not unit-stride
    over D is copied first. On the model's path autograd hands over the
    (B, H, Lq, D) view of the (B, Lq, H, D) output gradient, read in
    place."""
    if q.dtype != torch.float32:
        return flash_attention_bwd_fused_cuda(q, k, v, o, m, l, do, mask,
                                              causal, dropout_rate,
                                              dropout_key)
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, o, m, l, do, mask,
                                            causal, dropout_rate,
                                            dropout_key)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, m, l, do, delta, mask,
                                          causal, dropout_rate, dropout_key)
    return dq, dk, dv


# -- the gradient ------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash`` with ``_flash_fwd`` / ``_flash_bwd``:
    the forward keeps q, k, v, o and the stats m, l; the backward
    recomputes the probabilities from them. CUDA tensors take the kernels,
    CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, dropout_rate, dropout_key):
        if q.device.type == "cuda":
            o, m, l = flash_attention_fwd_lse_cuda(q, k, v, mask, causal,
                                                   dropout_rate, dropout_key)
        elif q.device.type == "cpu":
            o, m, l = attention_forward_lse_reference(
                q, k, v, mask, causal, dropout_rate, dropout_key or 0)
        else:
            raise ValueError(f"no attention path for device {q.device}")
        ctx.save_for_backward(q, k, v, o, m, l, mask)
        ctx.causal, ctx.rate, ctx.key = causal, dropout_rate, dropout_key
        ctx.mark_non_differentiable(m, l)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        q, k, v, o, m, l, mask = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, o, m, l, do, mask, ctx.causal, ctx.rate, ctx.key)
        else:
            dq, dk, dv = attention_backward_reference(
                q, k, v, o, m, l, do, mask, ctx.causal, ctx.rate,
                ctx.key or 0)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False, dropout_rate: float = 0.0,
                    dropout_key: Optional[int] = None) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D).

    Without a gradient to record and without dropout: the plain forward
    on CPU tensors, the forward kernel on CUDA tensors. Otherwise
    ``FlashAttention`` (training forward, backward kernels)."""
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if needs_grad or dropout_rate:
        return FlashAttention.apply(q, k, v, mask, causal, dropout_rate,
                                    dropout_key)[0]
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, mask, causal)
    raise ValueError(f"no attention path for device {q.device}")
