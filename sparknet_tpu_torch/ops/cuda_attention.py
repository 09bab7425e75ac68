"""Attention kernels for Hopper, with their plain PyTorch versions.

The port of ``sparknet_tpu/ops/pallas_attention.py``.  Four CUDA
kernels, written by hand for ``sm_90a`` (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` and ``csrc/decode_attention.cu``, built by
``_build.py``), replace the four Pallas kernels that LM serving and LM
training run:

- ``_flash_core``: the flash forward (``_fwd_kernel``), used by
  prefill, the canary scorer and every training forward;
- ``flash_bwd_dq`` / ``flash_bwd_dkv``: the flash backward
  (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), the backward of the
  ``torch.autograd.Function`` around ``_flash_core`` that makes
  ``flash_attention`` and ``flash_attention_step`` differentiable;
- ``decode_attention``: one query position over a gathered context
  (``_decode_kernel``), used by every decode step.

Routing is by the tensors' device and nothing else: a CPU tensor goes
to the plain version beside each kernel (``_flash_core_reference``,
``_flash_bwd_dq_reference``, ``_flash_bwd_dkv_reference``,
``decode_attention_reference``), a CUDA tensor to the kernel — and a
CUDA tensor the kernel does not take raises; it never falls back.
``LAUNCHES`` counts kernel launches (one per wrapper call that
launched), so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from sparknet_tpu_torch.ops import _build

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attention": 0}

KERNEL_HEAD_DIMS = (32, 64, 128)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@lru_cache(maxsize=None)
def _kernel(name: str, symbol: str, argtypes: tuple):
    fn = getattr(_build.load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(what: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"{what}: expected (B, T, H, D) tensors with unit stride "
                f"along D, got shape {tuple(t.shape)} strides {t.stride()}"
            )
    d = tensors[0].shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{what}: head_dim {d} has no kernel build "
            f"(built for {KERNEL_HEAD_DIMS})"
        )


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {rc})")


# ----------------------------------------------------------------------
# Flash forward (K1)
# ----------------------------------------------------------------------
def _flash_core_reference(q, k, v, q_offset: int, k_offset: int,
                          causal: bool):
    """Plain version of the flash forward: what ``_fwd_kernel``
    computes, densely.  (B, T, H, D) in; ``(o (B, Tq, H, D), lse (B, H,
    Tq))`` out, a fully-masked row giving ``(0, -inf)``."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float()
    ) * scale
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / l.clamp_min(1e-30)
    lse = torch.where(
        l[..., 0] > 0, m_safe[..., 0] + torch.log(l[..., 0]),
        torch.full_like(l[..., 0], float("-inf")),
    )
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def _flash_core(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """``(o (B, Tq, H, D), lse (B, H, Tq) float32)`` with the causal
    mask taken from ABSOLUTE positions (query row r at ``q_offset + r``,
    key c at ``k_offset + c``) — the counterpart of
    ``flash_attention_step``'s partial attention, in the port's
    (B, T, H, D) layout."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tq == 0:
        raise ValueError(
            "flash_attention: T_q=0 — an empty query block has no "
            "attention output (check the caller's slicing)"
        )
    if q.device.type == "cpu":
        return _flash_core_reference(q, k, v, q_offset, k_offset, causal)
    _check_cuda("flash_attention", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not line up"
        )
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _kernel("flash_fwd", "sparknet_flash_fwd_f32", (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _I, _F, _P,
    ))
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(q_offset), int(k_offset), int(bool(causal)),
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain version of ``flash_attention`` (dense, same numerics as
    the Pallas kernel: fp32 scores, ``(0, -inf)`` for masked rows)."""
    tq, tk = q.shape[1], k.shape[1]
    return _flash_core_reference(q, k, v, tk - tq, 0, causal)[0]


# ----------------------------------------------------------------------
# Flash backward (K3 dq, K4 dk/dv)
# ----------------------------------------------------------------------
def _bwd_terms(q, k, v, do, o, lse, dlse, q_offset: int, k_offset: int,
               causal: bool):
    """``(p, ds)`` of the flash backward, densely, (B, H, Tq, Tk) float32:
    the formulas of ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    # a fully-masked row has lse = -inf: lse 0 there keeps exp(-inf) = 0
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(s - lse_safe[..., None])
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()) - dlse
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _flash_bwd_dq_reference(q, k, v, do, o, lse, dlse, q_offset: int,
                            k_offset: int, causal: bool):
    """Plain version of K3: ``dq = ds k``, (B, Tq, H, D)."""
    _, ds = _bwd_terms(q, k, v, do, o, lse, dlse, q_offset, k_offset, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _flash_bwd_dkv_reference(q, k, v, do, o, lse, dlse, q_offset: int,
                             k_offset: int, causal: bool):
    """Plain version of K4: ``(dk = ds^T q, dv = p^T do)``, each
    (B, Tk, H, D)."""
    p, ds = _bwd_terms(q, k, v, do, o, lse, dlse, q_offset, k_offset, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


_BWD_INPUTS = (_P,) * 7  # q, k, v, o, do, lse, dlse
_STRIDES = ctypes.c_longlong * 15
_STRIDES_P = ctypes.POINTER(ctypes.c_longlong)


def _bwd_launch_args(what, q, k, v, do, o, lse, dlse):
    """Check what K3/K4 take and return the leading C arguments: the
    input pointers, and the (b, t, h) strides of q, k, v, o, do."""
    _check_cuda(what, q, k, v, do, o)
    b, tq, h, _ = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]
            or do.shape != q.shape or o.shape != q.shape):
        raise ValueError(
            f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} do {tuple(do.shape)} o {tuple(o.shape)} do "
            "not line up"
        )
    for name, t in (("lse", lse), ("dlse", dlse)):
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != (b, h, tq) or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous (B, H, T_q) float32 "
                f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, dlse)]
    strides = _STRIDES(*[t.stride(i) for t in (q, k, v, o, do)
                         for i in range(3)])
    return ptrs, strides


def flash_bwd_dq(q, k, v, do, o, lse, dlse, q_offset: int, k_offset: int,
                 causal: bool):
    """dq of the flash backward: K3 on CUDA tensors, its plain version
    on CPU tensors.  q, o, do (B, Tq, H, D); k, v (B, Tk, H, D); lse,
    dlse (B, H, Tq)."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_reference(q, k, v, do, o, lse, dlse,
                                       q_offset, k_offset, causal)
    ptrs, strides = _bwd_launch_args("flash_bwd_dq", q, k, v, do, o, lse, dlse)
    b, tq, h, d = q.shape
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel("flash_bwd", "sparknet_flash_bwd_dq_f32", (
        *_BWD_INPUTS, _P, _I, _I, _I, _I, _I, _STRIDES_P, _I, _I, _I, _F, _P,
    ))
    with torch.cuda.device(q.device):
        rc = fn(
            *ptrs, dq.data_ptr(),
            b, h, tq, k.shape[1], d, strides,
            int(q_offset), int(k_offset), int(bool(causal)),
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, o, lse, dlse, q_offset: int, k_offset: int,
                  causal: bool):
    """``(dk, dv)`` of the flash backward: K4 on CUDA tensors, its plain
    version on CPU tensors.  Shapes as ``flash_bwd_dq``."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_reference(q, k, v, do, o, lse, dlse,
                                        q_offset, k_offset, causal)
    ptrs, strides = _bwd_launch_args("flash_bwd_dkv", q, k, v, do, o, lse,
                                     dlse)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=q.device)
    fn = _kernel("flash_bwd", "sparknet_flash_bwd_dkv_f32", (
        *_BWD_INPUTS, _P, _P, _I, _I, _I, _I, _I, _STRIDES_P, _I, _I, _I, _F,
        _P,
    ))
    with torch.cuda.device(q.device):
        rc = fn(
            *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, d, strides,
            int(q_offset), int(k_offset), int(bool(causal)),
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashCore(torch.autograd.Function):
    """``(o, lse)`` of ``_flash_core`` (K1), differentiable in q, k and
    v through K3 and K4 — the port of the JAX package's ``custom_vjp``.
    The lse output is honest: its cotangent feeds the backward's delta
    term (a ``None`` cotangent counts as zeros)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, k_offset: int, causal: bool):
        o, lse = _flash_core(q, k, v, q_offset, k_offset, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.pos = (int(q_offset), int(k_offset), bool(causal))
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do
        if do.stride(-1) != 1:
            do = do.contiguous()
        dlse = (torch.zeros_like(lse) if dlse is None
                else dlse.to(torch.float32).contiguous())
        dq = flash_bwd_dq(q, k, v, do, o, lse, dlse, *ctx.pos)
        dk, dv = flash_bwd_dkv(q, k, v, do, o, lse, dlse, *ctx.pos)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128):
    """Fused attention on (B, T, H, D) with the end-aligned
    ``tril(k=tk-tq)`` causal convention of ``mha_reference``;
    differentiable (K3/K4 backward).

    ``block_q`` keeps the JAX signature: there it is the Pallas q-block
    a ragged T_q is padded to.  The result does not depend on it — the
    CUDA kernels tile their rows and mask a ragged T_q in place."""
    if block_q < 1:
        raise ValueError(f"block_q must be >= 1, got {block_q}")
    tq, tk = q.shape[1], k.shape[1]
    return _FlashCore.apply(q, k, v, tk - tq, 0, causal)[0]


def flash_attention_step(q, k, v, q_offset: int, k_offset: int,
                         causal: bool = False):
    """One partial-attention step with ABSOLUTE positions (the ring's
    unit): ``q``/``k``/``v`` (B, T_q, H, D)/(B, T_k, H, D), their first
    rows at ``q_offset``/``k_offset``.  Returns ``(o (B, H, T_q, D), lse
    (B, H, T_q))`` — normalized within the step, a fully-masked row (0,
    -inf) — with exact gradients through both outputs."""
    o, lse = _FlashCore.apply(q, k, v, q_offset, k_offset, causal)
    return o.permute(0, 2, 1, 3), lse


# ----------------------------------------------------------------------
# Decode attention (K2)
# ----------------------------------------------------------------------
def decode_attention_reference(q, k, v, lengths=None):
    """Dense masked decode attention — the plain version of the decode
    kernel (``_decode_reference`` of the JAX package)."""
    b, _, h, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float()
    ) * scale
    if lengths is not None:
        k_pos = torch.arange(s, device=q.device)
        valid = k_pos[None, :] < lengths.to(torch.int64)[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def decode_attention(q, k, v, lengths=None):
    """Single-position attention for autoregressive decode.

    ``q`` is (B, 1, H, D); ``k``/``v`` are (B, S, H, D) gathered context
    where only the first ``lengths[b]`` rows of sequence b are valid
    (the paged-KV gather over-allocates to the static S); ``lengths``
    None means the whole context is valid."""
    b, tq, h, d = q.shape
    if tq != 1:
        raise ValueError(f"decode_attention wants q_len=1, got {tq}")
    s = k.shape[1]
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths)
    _check_cuda("decode_attention", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not line up"
        )
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or tuple(lengths.shape) != (b,) or not lengths.is_contiguous()):
        raise ValueError(
            "decode_attention: lengths must be a contiguous (B,) int32 "
            f"tensor on {q.device}, got {lengths.dtype} "
            f"{tuple(lengths.shape)} on {lengths.device}"
        )
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel("decode_attention", "sparknet_decode_attention_f32", (
        _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _F, _P,
    ))
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), b, s, h, d,
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
