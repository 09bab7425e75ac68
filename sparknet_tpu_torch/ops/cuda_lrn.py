"""Cross-channel LRN kernels for Hopper, with their plain PyTorch version.

The port of ``sparknet_tpu/ops/pallas_lrn.py``.  Two CUDA kernels,
written by hand for ``sm_90a`` (``csrc/lrn.cu``, built by ``_build.py``),
replace its two Pallas kernels:

- ``lrn_fwd`` (K5, ``_fwd_kernel``): ``scale = k + (alpha/n) S(x^2)``,
  ``y = x scale^-beta``;
- ``lrn_bwd`` (K6, ``_bwd_kernel``): ``p = scale^-beta`` recomputed from
  ``x``, ``dx = p dy - (2 alpha beta/n) x S(dy x p / scale)``;

with ``S`` the centred window sum over channels (Caffe's pre-pad
``(n-1)//2``).  ``lrn_across_channels`` is the differentiable op: a
``torch.autograd.Function`` that saves only ``x``.

In the JAX package ``SPARKNET_PALLAS_LRN`` chooses the Pallas kernel over
the XLA ``custom_vjp`` form (``sparknet_tpu/ops/vision.py:439-472``).
Here that form is the plain version (``lrn_across_reference``,
``lrn_across_bwd_reference``), and a plain version may not carry the
path on the card, so the variable has nothing left to choose: on a CUDA
tensor every ACROSS_CHANNELS LRN runs K5 forward and K6 backward, on a
CPU tensor the plain version.  K5 takes float32 and bfloat16 (the TPU
kernel's any float dtype with float32 math, ``pallas_lrn.py:65-67``: the
bf16 plain version is the float32 one on the widened input, narrowed
once), K6 float32 only.  A CUDA tensor the kernels do not take (another
dtype, not a contiguous NCHW tensor, a window wider than 15) raises;
nothing falls back.  ``LAUNCHES`` counts kernel launches (K5's in
either dtype under ``lrn_fwd``).

The plain version sums each window in the Pallas order (centre, then the
post side d = 1.., then the pre side d = 1..; ``pallas_lrn.py:50-61``)
and the kernels add in the same order, one rounding at a time, so the
two agree bit for bit on the card (``chip_smoke.py`` holds K6
and K5 to that at AlexNet's two LRN inputs).  K5 takes ``FWD_CHUNK``
channels a grid row, K6 ``BWD_CHUNK`` and the fused kernels ``CHUNK``.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.ops import _build

LAUNCHES = {"lrn_fwd": 0, "lrn_bwd": 0}
# serving replicas launch from their own threads: count under a lock
_COUNT_LOCK = threading.Lock()

# channels per grid row of the kernels (csrc/lrn.cu, csrc/lrn_pool.cu);
# K5 takes FWD_CHUNK and K6 BWD_CHUNK, chosen with tools/lrn_tiles.py
# (PERF.md §6)
CHUNK = 32
FWD_CHUNK = 12
BWD_CHUNK = 64
# the widest window the kernels are built for (LRN_MAX_D = 7 each side)
MAX_LOCAL_SIZE = 15

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def negpow_q(beta: float) -> int:
    """``4 beta`` when ``s^-beta`` takes the sqrt/rsqrt composition (an
    integer in 1..8), else 0 (``pow``)."""
    q = round(4 * beta)
    return q if math.isclose(4 * beta, q) and 1 <= q <= 8 else 0


def fast_negpow(s: torch.Tensor, beta: float) -> torch.Tensor:
    """``s ** -beta`` from sqrt/rsqrt/multiplies when 4*beta is a small
    integer (every zoo LRN uses beta=0.75) — the JAX package's
    ``_fast_negpow`` composition, so both sides round alike."""
    q = negpow_q(beta)
    if not q:
        return torch.pow(s, -beta)
    r1 = torch.rsqrt(torch.sqrt(s))
    out = None
    p = r1
    while q:
        if q & 1:
            out = p if out is None else out * p
        q >>= 1
        if q:
            p = p * p
    return out


def window_sum(v: torch.Tensor, n: int) -> torch.Tensor:
    """Centred window sum over the channels (axis 1) of an NCHW tensor,
    window ``n``, pre-pad ``(n-1)//2``, in the Pallas order: the centre,
    then the post side d = 1.., then the pre side d = 1..; channels past
    either end count as zeros."""
    c = v.shape[1]
    pre = (n - 1) // 2
    post = n - 1 - pre
    acc = v
    for d in range(1, min(post, c - 1) + 1):  # channels i+d
        acc = acc + F.pad(v[:, d:], (0, 0, 0, 0, 0, d))
    for d in range(1, min(pre, c - 1) + 1):  # channels i-d
        acc = acc + F.pad(v[:, :-d], (0, 0, 0, 0, d, 0))
    return acc


def lrn_scale(x: torch.Tensor, n: int, alpha: float, beta: float, k: float):
    """``(scale, p = scale^-beta)`` of the LRN at every element."""
    scale = k + (alpha / n) * window_sum(x * x, n)
    return scale, fast_negpow(scale, beta)


def lrn_across_reference(x, n: int, alpha: float, beta: float, k: float):
    """Plain version of K5: ``y = x (k + (alpha/n) S(x^2))^-beta``."""
    _, p = lrn_scale(x, n, alpha, beta, k)
    return x * p


def lrn_fwd_bf16_reference(x, n: int, alpha: float, beta: float, k: float):
    """Plain version of K5 in bfloat16: float32 math on the widened
    input, the output narrowed once (round to nearest even)."""
    return lrn_across_reference(x.float(), n, alpha, beta, k).to(torch.bfloat16)


def lrn_across_bwd_reference(x, dy, n: int, alpha: float, beta: float,
                             k: float):
    """Plain version of K6: ``dx`` for the output cotangent ``dy``, Caffe's
    analytic backward (``lrn_layer.cpp`` CrossChannelBackward) with the
    scale recomputed from ``x``."""
    scale, p = lrn_scale(x, n, alpha, beta, k)
    inner = window_sum(dy * x * p / scale, n)
    return p * dy - (2.0 * alpha * beta / n) * x * inner


def check_cuda(what: str, *tensors, dtypes=(torch.float32,)) -> None:
    """Raise on a tensor the kernels do not take: they take contiguous
    NCHW tensors of one of ``dtypes`` (float32 unless a kernel says
    otherwise) on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{what}: the kernel takes {names}, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(
                f"{what}: the kernel takes NCHW tensors, got shape "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")


def hp_args(what: str, n: int, alpha: float, beta: float, k: float):
    """The kernels' LRN arguments ``(pre, post, k, alpha/n, coef, q,
    -beta)``; raises on a window the kernels are not built for."""
    n = int(n)
    if not 1 <= n <= MAX_LOCAL_SIZE:
        raise ValueError(
            f"{what}: local_size {n}: the kernels take 1..{MAX_LOCAL_SIZE}"
        )
    pre = (n - 1) // 2
    return (pre, n - 1 - pre, float(k), alpha / n, 2.0 * alpha * beta / n,
            negpow_q(beta), -float(beta))


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lrn_fwd(x, n: int, alpha: float, beta: float, k: float):
    """The LRN forward: K5 on a CUDA tensor (float32 or bfloat16, the
    output in the input's dtype), its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return lrn_fwd_bf16_reference(x, n, alpha, beta, k)
        return lrn_across_reference(x, n, alpha, beta, k)
    check_cuda("lrn_fwd", x, dtypes=(torch.float32, torch.bfloat16))
    pre, post, kk, an, _, q, nb = hp_args("lrn_fwd", n, alpha, beta, k)
    N, C, H, W = x.shape
    y = torch.empty_like(x)
    entry = ("sparknet_lrn_fwd_bf16" if x.dtype == torch.bfloat16
             else "sparknet_lrn_fwd_f32")
    fn = _build.kernel("lrn", entry,
                (_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _F, _P))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), N, C, H * W, FWD_CHUNK, pre, post,
                kk, an, q, nb, stream(x))
    _build.raise_on(rc, "lrn_fwd")
    with _COUNT_LOCK:
        LAUNCHES["lrn_fwd"] += 1
    return y


def lrn_bwd(x, dy, n: int, alpha: float, beta: float, k: float):
    """The LRN backward: K6 on CUDA tensors, its plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return lrn_across_bwd_reference(x, dy, n, alpha, beta, k)
    check_cuda("lrn_bwd", x, dy)
    if dy.shape != x.shape:
        raise ValueError(
            f"lrn_bwd: dy {tuple(dy.shape)} for x {tuple(x.shape)}"
        )
    pre, post, kk, an, coef, q, nb = hp_args("lrn_bwd", n, alpha, beta, k)
    N, C, H, W = x.shape
    dx = torch.empty_like(x)
    fn = _build.kernel("lrn", "sparknet_lrn_bwd_f32",
                (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _F, _P))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), N, C, H * W,
                BWD_CHUNK, pre, post, kk, an, coef, q, nb, stream(x))
    _build.raise_on(rc, "lrn_bwd")
    with _COUNT_LOCK:
        LAUNCHES["lrn_bwd"] += 1
    return dx


class _LRNAcross(torch.autograd.Function):
    """ACROSS_CHANNELS LRN with Caffe's analytic backward; only ``x`` is
    saved, the scale is recomputed in the backward (the JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, x, n, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hp = (n, alpha, beta, k)
        return lrn_fwd(x, n, alpha, beta, k)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return lrn_bwd(x, dy.contiguous(), *ctx.hp), None, None, None, None


def lrn_across_channels(x, n: int, alpha: float, beta: float, k: float):
    """Caffe ACROSS_CHANNELS LRN on an NCHW tensor, differentiable: K5/K6
    on the card, the plain version on the CPU."""
    return _LRNAcross.apply(x, int(n), float(alpha), float(beta), float(k))
