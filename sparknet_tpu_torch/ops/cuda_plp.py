"""Fused cross-channel LRN + 3x3/2 max pool for Hopper, with its plain
PyTorch version.

The port of ``sparknet_tpu/ops/pallas_plp.py``: ``lrn_maxpool(x, n,
alpha, beta, k)`` is ``maxpool_3x3_s2(lrn_across(x))`` on NCHW, for the
AlexNet sandwich ``normK -> poolK``.  Two CUDA kernels, written by hand
for ``sm_90a`` (``csrc/lrn_pool.cu``; its bf16 instantiations built from
``csrc/lrn_pool_bf16.cu``, by ``_build.py``), replace
its two Pallas kernels:

- ``lrn_pool_fwd`` (K7, ``_fwd_kernel``): the LRN output of each pooled
  tile's input window is formed on the chip and never written; only the
  pooled tensor is;
- ``lrn_pool_bwd`` (K8, ``_bwd_kernel``): recomputed from ``x`` alone,
  each pooled gradient routed to one position of its window, then the
  LRN backward of ``cuda_lrn`` applied to the routed gradient.

Routing is the Pallas kernel's (``pallas_plp.py:192-221``), which is not
Caffe's row-major scan and not ``F.max_pool2d``'s: a window's gradient
goes to the first COLUMN b = 0, 1, 2 whose 3-row max equals the pooled
value, then to the first ROW of that column equal to the column max.
The plain version (``lrn_maxpool_reference``,
``lrn_maxpool_bwd_reference``) implements that rule explicitly.

Both kernels take float32 and bfloat16: in bf16 the inputs are widened,
y, the routing and dx are float32 (routing by the first maximum of the
float32 y, as the TPU kernel routes) and the output is narrowed once, so
a bf16 plain version is the float32 one on the widened inputs, narrowed
(``lrn_maxpool_bf16_reference``, ``lrn_maxpool_bwd_bf16_reference``).

``fusable`` is the JAX package's geometry gate: MAX 3x3/2 pad 0 over an
odd H and W >= 3 after an ACROSS_CHANNELS LRN of odd size.  The wrappers
raise on anything else, and on a CUDA tensor the kernels do not take;
CPU tensors take the plain version.  ``LAUNCHES`` counts each kernel's
launches, the bfloat16 ones under the kernel's name with ``_bf16`` after
it.
"""

from __future__ import annotations

import ctypes

import torch

from sparknet_tpu_torch.ops import _build, cuda_lrn

LAUNCHES = {"lrn_pool_fwd": 0, "lrn_pool_bwd": 0, "lrn_pool_fwd_bf16": 0,
            "lrn_pool_bwd_bf16": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pooled_hw(h: int, w: int):
    return (h - 3) // 2 + 1, (w - 3) // 2 + 1


def fusable(norm_region: str, n: int, pool_method: str, kernel, stride,
            pad, h: int, w: int) -> bool:
    """Geometry gate of the fused path (``pallas_plp.fusable``)."""
    return (
        norm_region.upper() == "ACROSS_CHANNELS"
        and n % 2 == 1
        and pool_method.upper() == "MAX"
        and tuple(kernel) == (3, 3)
        and tuple(stride) == (2, 2)
        and tuple(pad) == (0, 0)
        and h % 2 == 1
        and w % 2 == 1
        and h >= 3
        and w >= 3
    )


def _check_geometry(what: str, x, n: int) -> None:
    if x.dim() != 4 or not fusable("ACROSS_CHANNELS", int(n), "MAX", (3, 3),
                                   (2, 2), (0, 0), x.shape[2], x.shape[3]):
        raise ValueError(
            f"{what}: not a fusable LRN + 3x3/2 max pool: x "
            f"{tuple(x.shape)}, local_size {n} (odd H, W >= 3 and an odd "
            "local_size)"
        )


def _pool_parts(y):
    """The window rows, the 3-row max of every column, the window columns
    of that max and the pooled value, as the Pallas kernel forms them."""
    ph, pw = pooled_hw(y.shape[2], y.shape[3])
    rows = [y[:, :, r:r + 2 * ph - 1:2] for r in range(3)]  # (N, C, ph, W)
    rowmax = torch.maximum(torch.maximum(rows[0], rows[1]), rows[2])
    cols = [rowmax[..., b:b + 2 * pw - 1:2] for b in range(3)]  # (.., ph, pw)
    pooled = torch.maximum(torch.maximum(cols[0], cols[1]), cols[2])
    return rows, rowmax, cols, pooled


def route_reference(y, dy):
    """The pooled gradient ``dy`` (N, C, ph, pw) routed onto ``y``'s
    positions by the Pallas rule, summed in the Pallas order: stage 1
    sends each window's gradient to its first column whose 3-row max is
    the pooled value, stage 2 each column's gradient to its first row
    equal to the column max."""
    ph, pw = pooled_hw(y.shape[2], y.shape[3])
    rows, rowmax, cols, pooled = _pool_parts(y)
    zero = torch.zeros_like(dy)
    d_rowmax = torch.zeros_like(rowmax)
    taken = torch.zeros_like(pooled, dtype=torch.bool)
    for b in range(3):
        m = (cols[b] == pooled) & ~taken
        taken = taken | m
        d_rowmax[..., b:b + 2 * pw - 1:2] += torch.where(m, dy, zero)
    zero = torch.zeros_like(d_rowmax)
    da, taken = [], torch.zeros_like(rowmax, dtype=torch.bool)
    for r in rows:
        m = (r == rowmax) & ~taken
        taken = taken | m
        da.append(torch.where(m, d_rowmax, zero))
    g = torch.zeros_like(y)
    g[:, :, 0:2 * ph - 1:2] = da[0]   # row 0 of window-row u: 2u
    g[:, :, 2:2 * ph + 1:2] += da[2]  # row 2 of window-row u: 2u + 2
    g[:, :, 1:2 * ph:2] = da[1]       # row 1: 2u + 1
    return g


def lrn_maxpool_reference(x, n: int, alpha: float, beta: float, k: float):
    """Plain version of K7: the LRN, then the 3x3/2 max."""
    return _pool_parts(cuda_lrn.lrn_across_reference(x, n, alpha, beta, k))[3]


def lrn_maxpool_bwd_reference(x, dy, n: int, alpha: float, beta: float,
                              k: float):
    """Plain version of K8: ``dy`` routed by the Pallas rule, then the LRN
    backward."""
    y = cuda_lrn.lrn_across_reference(x, n, alpha, beta, k)
    return cuda_lrn.lrn_across_bwd_reference(x, route_reference(y, dy), n,
                                             alpha, beta, k)


def lrn_maxpool_bf16_reference(x, n: int, alpha: float, beta: float,
                               k: float):
    """Plain version of K7 in bfloat16: the float32 plain version on the
    widened input, the pooled output narrowed once."""
    return lrn_maxpool_reference(x.float(), n, alpha, beta, k).to(
        torch.bfloat16)


def lrn_maxpool_bwd_bf16_reference(x, dy, n: int, alpha: float, beta: float,
                                   k: float):
    """Plain version of K8 in bfloat16: the float32 plain version (routed
    by the float32 y) on the widened inputs, dx narrowed once."""
    return lrn_maxpool_bwd_reference(x.float(), dy.float(), n, alpha, beta,
                                     k).to(torch.bfloat16)


def _kernel(name: str, x, argtypes):
    """The C entry of kernel ``name`` for ``x``'s dtype: the float32 one
    of ``csrc/lrn_pool.cu`` or the bfloat16 one of ``lrn_pool_bf16.cu``."""
    if x.dtype == torch.bfloat16:
        return _build.kernel("lrn_pool_bf16", f"sparknet_{name}_bf16", argtypes)
    return _build.kernel("lrn_pool", f"sparknet_{name}_f32", argtypes)


def lrn_pool_fwd(x, n: int, alpha: float, beta: float, k: float):
    """The fused forward: K7 on a CUDA tensor (float32 or bfloat16, the
    output in its dtype), its plain version on a CPU tensor."""
    _check_geometry("lrn_pool_fwd", x, n)
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return lrn_maxpool_bf16_reference(x, n, alpha, beta, k)
        return lrn_maxpool_reference(x, n, alpha, beta, k)
    cuda_lrn.check_cuda("lrn_pool_fwd", x)
    pre, post, kk, an, _, q, nb = cuda_lrn.hp_args("lrn_pool_fwd", n, alpha,
                                                   beta, k)
    N, C, H, W = x.shape
    out = torch.empty((N, C) + pooled_hw(H, W), dtype=x.dtype, device=x.device)
    fn = _kernel("lrn_pool_fwd", x,
                 (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _F, _P))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), N, C, H, W, cuda_lrn.CHUNK, pre,
                post, kk, an, q, nb, cuda_lrn.stream(x))
    _build.raise_on(rc, "lrn_pool_fwd")
    cuda_lrn.count_launch(LAUNCHES, "lrn_pool_fwd", x.dtype)
    return out


def lrn_pool_bwd(x, dy, n: int, alpha: float, beta: float, k: float):
    """The fused backward: K8 on CUDA tensors (float32 or bfloat16, dx
    in their dtype), its plain version on CPU tensors."""
    _check_geometry("lrn_pool_bwd", x, n)
    N, C, H, W = x.shape
    if tuple(dy.shape) != (N, C) + pooled_hw(H, W):
        raise ValueError(
            f"lrn_pool_bwd: dy {tuple(dy.shape)} for x {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return lrn_maxpool_bwd_bf16_reference(x, dy, n, alpha, beta, k)
        return lrn_maxpool_bwd_reference(x, dy, n, alpha, beta, k)
    cuda_lrn.check_cuda("lrn_pool_bwd", x, dy)
    pre, post, kk, an, coef, q, nb = cuda_lrn.hp_args("lrn_pool_bwd", n,
                                                      alpha, beta, k)
    dx = torch.empty_like(x)
    fn = _kernel("lrn_pool_bwd", x,
                 (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _F,
                  _P))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), N, C, H, W,
                cuda_lrn.CHUNK, pre, post, kk, an, coef, q, nb,
                cuda_lrn.stream(x))
    _build.raise_on(rc, "lrn_pool_bwd")
    cuda_lrn.count_launch(LAUNCHES, "lrn_pool_bwd", x.dtype)
    return dx


class _LRNMaxPool(torch.autograd.Function):
    """``lrn_maxpool`` with its fused backward; only ``x`` is saved (the
    JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, x, n, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hp = (n, alpha, beta, k)
        return lrn_pool_fwd(x, n, alpha, beta, k)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return (lrn_pool_bwd(x, dy.contiguous(), *ctx.hp),
                None, None, None, None)


def lrn_maxpool(x, n: int, alpha: float, beta: float, k: float):
    """``maxpool_3x3_s2(lrn_across_channels(x))`` on NCHW, fused and
    differentiable: K7/K8 on the card, the plain version on the CPU;
    float32 or bfloat16, the output and the gradient in ``x``'s dtype."""
    return _LRNMaxPool.apply(x, int(n), float(alpha), float(beta), float(k))
