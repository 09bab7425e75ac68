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
- ``paged_decode_attention``: one query position over the paged KV
  arena, read through the block table (``_decode_kernel``), used by
  every decode step; ``decode_attention``, the JAX function's
  counterpart over a gathered context, runs the same kernel.

Routing is by the tensors' device and nothing else: a CPU tensor goes
to the plain version beside each kernel (``_flash_core_reference``,
``_flash_bwd_dq_reference``, ``_flash_bwd_dkv_reference``,
``paged_decode_attention_reference``, ``decode_attention_reference``),
a CUDA tensor to the kernel — and a
CUDA tensor the kernel does not take raises; it never falls back.
``LAUNCHES`` counts kernel launches (one per wrapper call that
launched), so a run can show that its main path went through the
kernels.

The kernels are built for the head dims in ``KERNEL_HEAD_DIMS`` (every
multiple of 16 up to 128, then every multiple of 32 up to 256,
``csrc/head_dims.cuh``; above 128 K1, K3 and K4 split the output's
columns into halves, one a block).  On CUDA tensors any other head dim
D <= 256 is zero-padded up to the next built one, once: the autograd
path (``flash_attention``, ``flash_attention_step``) pads q, k and v in
the forward and keeps the padded tensors and o for the backward, which
pads only do; ``decode_attention`` pads its gathered k and v.  Each
copy is counted in ``PAD_COPIES``.  The paged decode pads nothing: the
pool keeps its rows at ``arena_head_dim(D)`` with the pad columns zero,
and K2 reads q and writes o at the true D.  The kernels run with the
scale of the true D, and o, dq, dk and dv are sliced back to D: zero
columns add nothing to q.kT and only give v columns that are dropped,
so lse is unchanged.  A head dim above 256 raises, naming the limit.
K1-K4 read (B, T, H, D) rows 16 bytes at a time, so every row must
start on 16 bytes.  The wrappers raise on what the kernels do not take;
the autograd path and the gathered decode hand them a contiguous copy
of any input or cotangent whose rows are not 16-byte aligned, counted
in ``ALIGN_COPIES``.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from sparknet_tpu_torch.ops import _build

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attention": 0}

KERNEL_HEAD_DIMS = tuple(range(16, 129, 16)) + tuple(range(160, 257, 32))
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]

# contiguous copies the autograd path and the gathered decode made of
# tensors whose rows were not 16-byte aligned, before a launch
ALIGN_COPIES = 0
# zero-padded copies the autograd path and the gathered decode made of
# tensors whose head dim is not one the kernels are built for, before a
# launch (the paged decode makes none)
PAD_COPIES = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def reset_launch_counts() -> None:
    global ALIGN_COPIES, PAD_COPIES
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ALIGN_COPIES = PAD_COPIES = 0


def _on_cpu(t) -> bool:
    """The wrappers' routing: a CPU tensor takes the plain version."""
    return t.device.type == "cpu"


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


def _kernel_head_dim(what: str, d: int) -> int:
    """The built head dim a head dim ``d`` runs at: ``d`` rounded up to
    a multiple of 16 up to 128, of 32 above; above ``MAX_HEAD_DIM`` it
    raises."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: head_dim {d} is above the kernels' limit of "
            f"{MAX_HEAD_DIM} (built for {KERNEL_HEAD_DIMS}; a smaller head "
            "dim is zero-padded up to the next of them)"
        )
    step = 16 if d <= 128 else 32
    return -(-d // step) * step


def _check_built_head_dim(what: str, d: int) -> None:
    """K1, K3 and K4 take a built head dim; the autograd path pads any
    other up to one."""
    if _kernel_head_dim(what, d) != d:
        raise ValueError(
            f"{what}: head_dim {d} is not one the kernels are built for "
            f"({KERNEL_HEAD_DIMS}); flash_attention zero-pads it"
        )


def _pad_head(t, dp: int):
    """``t`` zero-padded along D to ``dp`` (a copy, counted in
    ``PAD_COPIES``), or ``t`` itself when it is ``dp`` wide."""
    global PAD_COPIES
    if t.shape[-1] == dp:
        return t
    PAD_COPIES += 1
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))


def _unpad(t, d: int):
    """``t`` sliced back to the head dim ``d`` (itself when that wide)."""
    return t if t.shape[-1] == d else t[..., :d]


def _rows_aligned(t) -> bool:
    """Every (b, t, h) row of ``t`` starts on 16 bytes: K1, K3 and K4
    copy rows into shared memory with 16-byte ``cp.async``.  The stride
    of a dimension of size 1 is never stepped."""
    return t.data_ptr() % 16 == 0 and all(
        s % 4 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _check_rows_aligned(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if not _rows_aligned(t):
            raise ValueError(
                f"{what}: the kernel loads rows of {name} 16 bytes at a time: "
                "it needs a 16-byte aligned base and (b, t, h) strides that "
                f"are multiples of 4, got data_ptr {t.data_ptr()} strides "
                f"{t.stride()}"
            )


def _kernel_rows(t):
    """``t`` itself when its rows are 16-byte aligned (or it does not lie
    along D with unit stride, which the wrappers refuse), else a
    contiguous copy, counted in ``ALIGN_COPIES``."""
    global ALIGN_COPIES
    if t.stride(-1) != 1 or _rows_aligned(t):
        return t
    ALIGN_COPIES += 1
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_input(t, dp: int):
    """``t`` as K1, K3 and K4 read it at the built head dim ``dp``: a
    zero-padded copy when it is narrower and lies along D with unit
    stride (the wrappers refuse any other), else ``_kernel_rows(t)``."""
    if t.shape[-1] != dp and t.stride(-1) == 1:
        return _pad_head(t, dp)
    return _kernel_rows(t)


# ----------------------------------------------------------------------
# Flash forward (K1)
# ----------------------------------------------------------------------
def _flash_core_reference(q, k, v, q_offset: int, k_offset: int,
                          causal: bool, scale: float | None = None):
    """Plain version of the flash forward: what ``_fwd_kernel``
    computes, densely.  (B, T, H, D) in; ``(o (B, Tq, H, D), lse (B, H,
    Tq))`` out, a fully-masked row giving ``(0, -inf)``.  ``scale``
    defaults to ``1/sqrt(D)``."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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


def _flash_core(q, k, v, q_offset: int, k_offset: int, causal: bool,
                scale: float | None = None):
    """``(o (B, Tq, H, D), lse (B, H, Tq) float32)`` with the causal
    mask taken from ABSOLUTE positions (query row r at ``q_offset + r``,
    key c at ``k_offset + c``) — the counterpart of
    ``flash_attention_step``'s partial attention, in the port's
    (B, T, H, D) layout.  ``scale`` defaults to ``1/sqrt(D)``; the
    autograd path passes the unpadded D's."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tq == 0:
        raise ValueError(
            "flash_attention: T_q=0 — an empty query block has no "
            "attention output (check the caller's slicing)"
        )
    if _on_cpu(q):
        return _flash_core_reference(q, k, v, q_offset, k_offset, causal,
                                     scale)
    _check_cuda("flash_attention", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not line up"
        )
    _check_built_head_dim("flash_attention", d)
    _check_rows_aligned("flash_attention", q=q, k=k, v=v)
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _build.kernel("flash_fwd", "sparknet_flash_fwd_f32", (
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
            1.0 / math.sqrt(d) if scale is None else scale,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on(rc, "flash_attention")
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
               causal: bool, scale: float | None = None):
    """``(p, ds)`` of the flash backward, densely, (B, H, Tq, Tk) float32:
    the formulas of ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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
                            k_offset: int, causal: bool,
                            scale: float | None = None):
    """Plain version of K3: ``dq = ds k``, (B, Tq, H, D)."""
    _, ds = _bwd_terms(q, k, v, do, o, lse, dlse, q_offset, k_offset, causal,
                       scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _flash_bwd_dkv_reference(q, k, v, do, o, lse, dlse, q_offset: int,
                             k_offset: int, causal: bool,
                             scale: float | None = None):
    """Plain version of K4: ``(dk = ds^T q, dv = p^T do)``, each
    (B, Tk, H, D)."""
    p, ds = _bwd_terms(q, k, v, do, o, lse, dlse, q_offset, k_offset, causal,
                       scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


_BWD_INPUTS = (_P,) * 7  # q, k, v, o, do, lse, dlse
_STRIDES = ctypes.c_longlong * 15
_STRIDES_P = ctypes.POINTER(ctypes.c_longlong)


def _bwd_launch_args(what, q, k, v, do, o, lse, dlse, scale):
    """Check what K3/K4 take; return the (b, t, h) strides of q, k, v, o,
    do and the scale (``1/sqrt(D)`` by default)."""
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
    d = q.shape[-1]
    _check_built_head_dim(what, d)
    _check_rows_aligned(what, q=q, k=k, v=v, o=o, do=do)
    strides = _STRIDES(*[t.stride(i) for t in (q, k, v, o, do)
                         for i in range(3)])
    return strides, 1.0 / math.sqrt(d) if scale is None else scale


def flash_bwd_dq(q, k, v, do, o, lse, dlse, q_offset: int, k_offset: int,
                 causal: bool, scale: float | None = None):
    """dq of the flash backward: K3 on CUDA tensors, its plain version
    on CPU tensors.  q, o, do (B, Tq, H, D); k, v (B, Tk, H, D); lse,
    dlse (B, H, Tq); ``scale`` as ``_flash_core``'s."""
    if _on_cpu(q):
        return _flash_bwd_dq_reference(q, k, v, do, o, lse, dlse,
                                       q_offset, k_offset, causal, scale)
    strides, scale = _bwd_launch_args("flash_bwd_dq", q, k, v, do, o, lse,
                                      dlse, scale)
    b, tq, h, d = q.shape
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("flash_bwd", "sparknet_flash_bwd_dq_f32", (
        *_BWD_INPUTS, _P, _I, _I, _I, _I, _I, _STRIDES_P, _I, _I, _I, _F, _P,
    ))
    with torch.cuda.device(q.device):
        rc = fn(
            *[t.data_ptr() for t in (q, k, v, o, do, lse, dlse)],
            dq.data_ptr(), b, h, tq, k.shape[1], d, strides,
            int(q_offset), int(k_offset), int(bool(causal)),
            scale, torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, o, lse, dlse, q_offset: int, k_offset: int,
                  causal: bool, scale: float | None = None):
    """``(dk, dv)`` of the flash backward: K4 on CUDA tensors, its plain
    version on CPU tensors.  Shapes and ``scale`` as ``flash_bwd_dq``."""
    if _on_cpu(q):
        return _flash_bwd_dkv_reference(q, k, v, do, o, lse, dlse,
                                        q_offset, k_offset, causal, scale)
    strides, scale = _bwd_launch_args("flash_bwd_dkv", q, k, v, do, o, lse,
                                      dlse, scale)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=q.device)
    fn = _build.kernel("flash_bwd", "sparknet_flash_bwd_dkv_f32", (
        *_BWD_INPUTS, _P, _P, _I, _I, _I, _I, _I, _STRIDES_P, _I, _I, _I, _F,
        _P,
    ))
    with torch.cuda.device(q.device):
        rc = fn(
            *[t.data_ptr() for t in (q, k, v, o, do, lse, dlse)],
            dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, d, strides,
            int(q_offset), int(k_offset), int(bool(causal)),
            scale, torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashCore(torch.autograd.Function):
    """``(o, lse)`` of ``_flash_core`` (K1), differentiable in q, k and
    v through K3 and K4 — the port of the JAX package's ``custom_vjp``.
    The lse output is honest: its cotangent feeds the backward's delta
    term (a ``None`` cotangent counts as zeros).  On the card q, k and v
    are brought to a built head dim with 16-byte aligned rows once
    (``_kernel_input``) and kept so, with o at that width, for the
    backward, which brings only do there; the outputs and the gradients
    are sliced back to the true D."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, k_offset: int, causal: bool):
        d = q.shape[-1]
        if q.is_cuda:
            dp = _kernel_head_dim("flash_attention", d)
            q, k, v = (_kernel_input(t, dp) for t in (q, k, v))
        scale = 1.0 / math.sqrt(d)
        o, lse = _flash_core(q, k, v, q_offset, k_offset, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (int(q_offset), int(k_offset), bool(causal), scale)
        ctx.d = d
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return _unpad(o, d), lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        else:
            if do.stride(-1) != 1:
                do = do.clone(memory_format=torch.contiguous_format)
            if do.is_cuda:
                do = _kernel_input(do, o.shape[-1])
        dlse = (torch.zeros_like(lse) if dlse is None
                else dlse.to(torch.float32).contiguous())
        dq = flash_bwd_dq(q, k, v, do, o, lse, dlse, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, o, lse, dlse, *ctx.args)
        return (*(_unpad(t, ctx.d) for t in (dq, dk, dv)), None, None, None)


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
# per-device (B * H) ticket counters of K2's in-kernel merge: zero
# between launches (the merging CTA resets its own), so launches on one
# stream share them
_TICKETS: dict = {}


def arena_head_dim(d: int) -> int:
    """The width a head takes in a row of the paged KV arena: ``d``
    rounded up to the head dim K2 is built for, whose pad columns stay
    zero; ``d`` itself above ``MAX_HEAD_DIM``, which only the plain
    version (CPU tensors) takes."""
    return d if d > MAX_HEAD_DIM else _kernel_head_dim("decode_attention", d)


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


def paged_decode_attention_reference(q, arena_k, arena_v, block_table,
                                     lengths, block_size: int):
    """Plain version of the paged decode: the context gathered through
    the block table (position j of slot b at arena row ``table[b, j //
    block_size] * block_size + j % block_size``, the first D columns of
    a head), then ``decode_attention_reference``; a length of 0 gives
    o = 0, as the kernel does."""
    d = q.shape[-1]
    j = torch.arange(block_table.shape[1] * block_size, device=q.device)
    rows = (block_table.long()[:, j // block_size] * block_size
            + j % block_size)
    n = lengths.clamp(0, j.numel())
    o = decode_attention_reference(q, arena_k[rows, :, :d],
                                   arena_v[rows, :, :d], n)
    return o.masked_fill((n == 0)[:, None, None, None], 0.0)


@lru_cache(maxsize=None)
def _workspace_floats(b: int, h: int, dp: int, positions: int) -> int:
    """Floats of K2's workspace for B slots of H heads at head dim dp and
    contexts of up to ``positions``: its split partials."""
    return _build.kernel("decode_attention", "sparknet_paged_decode_workspace",
                         (_I,) * 4)(b, h, dp, positions)


def _paged_decode(what, q, k, v, table, lengths, block_size: int,
                  block_strides):
    """Launch K2: q (B, 1, H, D); position j of slot b at ``k + table[b,
    j // block_size] * sb + (j % block_size) * sr + h * sh``
    (``block_strides`` (sb, sr, sh) of k and of v), rows of the built
    head dim ``k.shape[-1]``."""
    b, _, h, d = q.shape
    dp = k.shape[-1]
    floats = _workspace_floats(b, h, dp, table.shape[1] * block_size)
    work = torch.empty((floats,), dtype=torch.float32, device=q.device)
    tickets = _TICKETS.get(q.device)
    if tickets is None or tickets.numel() < b * h:
        tickets = _TICKETS[q.device] = torch.zeros(
            (b * h,), dtype=torch.int32, device=q.device)
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("decode_attention", "sparknet_paged_decode_f32", (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P,
    ))
    (skb, skr, skh), (svb, svr, svh) = block_strides
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), work.data_ptr(),
            tickets.data_ptr(), b, h, d, dp, table.shape[1], block_size,
            q.stride(0), q.stride(2), skb, skr, skh, svb, svr, svh,
            table.stride(0), 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on(rc, what)
    LAUNCHES["decode_attention"] += 1
    return o


def _check_int32(what, name, t, shape, device):
    if (t.dtype != torch.int32 or t.device != device
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(
            f"{what}: {name} must be a contiguous {shape} int32 tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def paged_decode_attention(q, arena_k, arena_v, block_table, lengths,
                           block_size: int):
    """Single-position attention over the paged KV arena (K2 on CUDA
    tensors, its plain version on CPU tensors).

    ``q`` (B, 1, H, D); ``arena_k``/``arena_v`` one layer's (rows, H,
    Dp) view of the pool (``serve/kv_cache.py``), Dp >= D
    (``arena_head_dim(D)`` on the card); ``block_table`` (B, max_blocks)
    int32: position j of slot b lives at row ``block_table[b, j //
    block_size] * block_size + j % block_size``; ``lengths`` (B,) int32:
    positions at or past ``min(lengths[b], max_blocks * block_size)``
    are not read, and a length of 0 gives o = 0."""
    b, tq, h, d = q.shape
    what = "paged_decode_attention"
    if tq != 1:
        raise ValueError(f"{what} wants q_len=1, got {tq}")
    if block_size < 1:
        raise ValueError(f"{what}: block_size must be >= 1, got {block_size}")
    if (block_table.dim() != 2 or block_table.shape[0] != b
            or block_table.shape[1] < 1):
        raise ValueError(
            f"{what}: block_table must be (B={b}, max_blocks >= 1), got "
            f"{tuple(block_table.shape)}"
        )
    _check_int32(what, "block_table", block_table, tuple(block_table.shape),
                 q.device)
    _check_int32(what, "lengths", lengths, (b,), q.device)
    if (arena_k.dim() != 3 or arena_k.shape != arena_v.shape
            or arena_k.shape[1] != h or arena_k.shape[2] < d):
        raise ValueError(
            f"{what}: arenas must be (rows, H={h}, Dp >= {d}), got "
            f"{tuple(arena_k.shape)} and {tuple(arena_v.shape)}"
        )
    if _on_cpu(q):
        return paged_decode_attention_reference(
            q, arena_k, arena_v, block_table, lengths, block_size)
    dp = _kernel_head_dim(what, d)
    _check_cuda(what, q)
    for name, t in (("arena_k", arena_k), ("arena_v", arena_v)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(
                f"{what}: {name} must be float32 on {q.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if t.shape[-1] != dp or t.stride(-1) != 1:
            raise ValueError(
                f"{what}: the kernel reads head dim {d} at rows of {dp} "
                f"(arena_head_dim) with unit stride, got {name} "
                f"{tuple(t.shape)} strides {t.stride()}"
            )
        if t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4:
            raise ValueError(
                f"{what}: the kernel loads rows of {name} 16 bytes at a "
                "time: it needs a 16-byte aligned base and row and head "
                f"strides that are multiples of 4, got data_ptr "
                f"{t.data_ptr()} strides {t.stride()}"
            )
    strides = [(block_size * t.stride(0), t.stride(0), t.stride(1))
               for t in (arena_k, arena_v)]
    return _paged_decode(what, q, arena_k, arena_v, block_table, lengths,
                         block_size, strides)


def decode_attention(q, k, v, lengths=None):
    """Single-position attention for autoregressive decode.

    ``q`` is (B, 1, H, D); ``k``/``v`` are (B, S, H, D) gathered context
    where only the first ``lengths[b]`` rows of sequence b are valid;
    ``lengths`` None means the whole context is valid.  The counterpart
    of the JAX ``decode_attention``: on CUDA tensors it runs K2 on the
    context seen as B blocks of S rows with the identity table (k and v
    zero-padded to a built head dim first, counted in ``PAD_COPIES``)."""
    b, tq, h, d = q.shape
    if tq != 1:
        raise ValueError(f"decode_attention wants q_len=1, got {tq}")
    s = k.shape[1]
    if _on_cpu(q):
        return decode_attention_reference(q, k, v, lengths)
    _check_cuda("decode_attention", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not line up"
        )
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    _check_int32("decode_attention", "lengths", lengths, (b,), q.device)
    dp = _kernel_head_dim("decode_attention", d)
    k, v = (_kernel_rows(_pad_head(t, dp)) for t in (k, v))
    table = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
    return _paged_decode("decode_attention", q, k, v, table, lengths, s,
                         [t.stride()[:3] for t in (k, v)])
