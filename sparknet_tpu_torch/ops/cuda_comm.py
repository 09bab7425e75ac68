"""Averaging-epilogue kernels for Hopper, with their plain PyTorch versions.

The port of ``sparknet_tpu/ops/pallas_comm.py``.  Three CUDA kernels,
written by hand for ``sm_90a`` (``csrc/comm_epilogue.cu``, built by
``_build.py``), replace its three Pallas kernels; each runs one launch
per comm chunk of ``parallel/comm.py``:

- ``encode`` (K9, ``_encode_kernel``): ``delta = (x - a) + r``,
  per-tensor bf16 / int8 / fp32 quantize, the error-feedback residual
  ``delta - dequant(q)``, and optionally the per-worker error readout
  ``[max |err|, sum delta^2, sum err^2]``;
- ``apply_barriered`` (K10, ``_apply_barriered_kernel``): every worker
  lands on ``anchor + mean`` when any worker survived, a masked
  worker's residual resets;
- ``apply_correction`` (K11, ``_apply_correction_kernel``): the overlap
  correction ``mean - dequant(q)`` added to params and anchor.

Leaves are worker-stacked ``(W, ...)`` float32 tensors, means unstacked.
Routing is by the tensors' device and nothing else: CPU tensors take the
plain version beside each kernel (``*_reference``), CUDA tensors the
kernel — and a CUDA tensor the kernel does not take raises.
``LAUNCHES`` counts kernel launches.

The plain versions follow the op order of the JAX package's unfused
closures (``parallel/comm.py:313-425``) as XLA computes them on the CPU,
and the kernels equal them bit for bit.  Two of XLA's rewrites are part
of that arithmetic (measured on the JAX package's CPU backend): the
int8 scale ``amax / 127`` is computed as ``amax * (1/127)``, and
``delta - q * scale`` (and ``mean - q * scale``) as one fused
multiply-add.  The plain versions take that FMA exactly through float64:
an int8 times a float32 is exact there, and so is its difference with a
float32 of like size.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Sequence

import torch

from sparknet_tpu_torch.ops import _build

LAUNCHES = {"comm_encode": 0, "comm_apply_barriered": 0,
            "comm_apply_correction": 0}

MODES = {"fp32": 0, "bf16": 1, "int8": 2}
QDTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
MAX_LEAVES = 32  # the kernels' leaf table (csrc/comm_epilogue.cu)
INV127 = 1.0 / 127.0

_P, _I = ctypes.c_void_p, ctypes.c_int


class _Leaf(ctypes.Structure):
    """``struct Leaf`` of csrc/comm_epilogue.cu."""

    _fields_ = [
        ("x", _P), ("a", _P), ("r", _P), ("mean", _P), ("q", _P),
        ("scale", _P), ("out0", _P), ("out1", _P),
        ("n", ctypes.c_longlong), ("mode", ctypes.c_int),
    ]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@lru_cache(maxsize=None)
def _kernel(symbol: str, argtypes: tuple):
    fn = getattr(_build.load("comm_epilogue"), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _bshape(t: torch.Tensor, ndim: int):
    """``t`` (W,) viewed to broadcast over a (W, ...) leaf."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


def _fms(d: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``d - q * s`` rounded once, as XLA's fused multiply-add computes it."""
    return (d.double() - q.double() * s.double()).float()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(what: str, leaves: Sequence[torch.Tensor], *groups) -> int:
    """Validate a CUDA chunk; returns W.  ``groups`` are (name, tensors,
    stacked) triples that must line up with ``leaves``."""
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(
            f"{what}: a chunk of {len(leaves)} leaves (the kernel takes 1.."
            f"{MAX_LEAVES})"
        )
    dev = leaves[0].device
    w = leaves[0].shape[0]
    for name, ts, stacked in (("leaves", leaves, True),) + groups:
        if len(ts) != len(leaves):
            raise ValueError(f"{what}: {len(ts)} {name} for {len(leaves)} leaves")
        for t, x in zip(ts, leaves):
            if t.device != dev:
                raise ValueError(f"{what}: {name} on {t.device}, leaves on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous")
            want = tuple(x.shape) if stacked else tuple(x.shape[1:])
            if tuple(t.shape) != want:
                raise ValueError(
                    f"{what}: {name} shape {tuple(t.shape)}, expected {want}"
                )
    for x in leaves:
        if x.dtype != torch.float32 or x.dim() < 1 or x.shape[0] != w:
            raise TypeError(
                f"{what}: leaves must be float32 (W, ...) with W={w}, got "
                f"{x.dtype} {tuple(x.shape)}"
            )
    return w


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------------
# K9: encode
# ----------------------------------------------------------------------
def encode_reference(leaves, anchors, resids, modes, with_err: bool):
    """Plain version of ``encode``: the unfused ``encode_fn`` per leaf.
    Returns ``(qs, scales, new_resids, err)``; ``err`` is the (W, 3)
    per-worker ``[max |err|, sum delta^2, sum err^2]`` or None."""
    qs, scales, new_resids, parts = [], [], [], []
    for x, a, r, mode in zip(leaves, anchors, resids, modes):
        w = x.shape[0]
        delta = (x - a) + r
        zero = torch.zeros((w,), dtype=torch.float32, device=x.device)
        if mode == "bf16":
            q = delta.to(torch.bfloat16)
            scale = zero
            err = delta - q.float()
        elif mode == "int8":
            amax = delta.abs().reshape(w, -1).amax(dim=1)
            scale = torch.where(amax > 0, amax * INV127,
                                torch.ones_like(amax))
            sc = _bshape(scale, delta.dim())
            v = torch.clamp(torch.round(delta / sc), -127, 127)
            q = torch.where(torch.isnan(v), torch.zeros_like(v), v).to(torch.int8)
            err = _fms(delta, q, sc)
        elif mode == "fp32":
            q = delta
            scale = zero
            err = delta - delta
        else:
            raise ValueError(f"unknown comm mode {mode!r}")
        qs.append(q)
        scales.append(scale)
        new_resids.append(err)
        if with_err:
            parts.append(torch.stack([
                err.abs().reshape(w, -1).amax(dim=1),
                (delta * delta).reshape(w, -1).sum(dim=1),
                (err * err).reshape(w, -1).sum(dim=1),
            ], dim=1))
    return (tuple(qs), tuple(scales), tuple(new_resids),
            _combine_parts(torch.stack(parts, dim=1)) if with_err else None)


def _combine_parts(parts: torch.Tensor) -> torch.Tensor:
    """(W, leaves, 3) per-leaf readouts -> (W, 3): max, sum, sum."""
    return torch.stack([parts[..., 0].amax(dim=1), parts[..., 1].sum(dim=1),
                        parts[..., 2].sum(dim=1)], dim=1)


def encode(leaves, anchors, resids, modes, with_err: bool):
    """One-pass delta encode of a comm chunk (K9): see ``encode_reference``
    for the contract.  One kernel launch for the whole chunk."""
    modes = tuple(modes)
    if leaves[0].device.type == "cpu":
        return encode_reference(leaves, anchors, resids, modes, with_err)
    w = _check("comm encode", leaves, ("anchors", anchors, True),
               ("resids", resids, True))
    if len(modes) != len(leaves) or any(m not in MODES for m in modes):
        raise ValueError(f"comm encode: modes {modes} for {len(leaves)} leaves")
    dev = leaves[0].device
    qs = tuple(torch.empty(x.shape, dtype=QDTYPES[m], device=dev)
               for x, m in zip(leaves, modes))
    scales = tuple(torch.empty((w,), dtype=torch.float32, device=dev)
                   for _ in leaves)
    new_resids = tuple(torch.empty_like(x) for x in leaves)
    parts = (torch.empty((w, len(leaves), 3), dtype=torch.float32, device=dev)
             if with_err else None)
    table = (_Leaf * len(leaves))(*(
        _Leaf(x.data_ptr(), a.data_ptr(), r.data_ptr(), None, q.data_ptr(),
              s.data_ptr(), nr.data_ptr(), None, x[0].numel(), MODES[m])
        for x, a, r, q, s, nr, m in zip(leaves, anchors, resids, qs, scales,
                                        new_resids, modes)
    ))
    fn = _kernel("sparknet_comm_encode", (_P, _I, _I, _P, _P))
    with torch.cuda.device(dev):
        rc = fn(table, len(leaves), w, _ptr(parts), _stream(leaves[0]))
    _raise_on(rc, "comm encode")
    LAUNCHES["comm_encode"] += 1
    return qs, scales, new_resids, (
        _combine_parts(parts) if with_err else None
    )


# ----------------------------------------------------------------------
# K10: barriered apply
# ----------------------------------------------------------------------
def apply_barriered_reference(leaves, anchors, means, resids, alive, denom0):
    """Plain version of ``apply_barriered``: ``x = anchor + mean`` where
    any worker survived (``denom0 > 0``), else own params; a masked
    worker's residual resets to 0 when it rejoins the consensus."""
    have = denom0 > 0
    rejoin = (alive <= 0) & have
    new_leaves, new_resids = [], []
    for x, a, m, r in zip(leaves, anchors, means, resids):
        new_leaves.append(torch.where(have, a + m, x))
        new_resids.append(torch.where(_bshape(rejoin, x.dim()),
                                      torch.zeros_like(r), r))
    return tuple(new_leaves), tuple(new_resids)


def apply_barriered(leaves, anchors, means, resids, alive, denom0):
    """Barriered consensus apply of a comm chunk (K10).  ``alive`` is the
    (W,) float mask, ``denom0`` the survivor count (a 0-dim float32
    tensor on the leaves' device: read by the kernel, never by the host)."""
    if leaves[0].device.type == "cpu":
        return apply_barriered_reference(leaves, anchors, means, resids,
                                         alive, denom0)
    w = _check("comm apply_barriered", leaves, ("anchors", anchors, True),
               ("means", means, False), ("resids", resids, True))
    for name, t, shape in (("alive", alive, (w,)), ("denom0", denom0, ())):
        if (t.device != leaves[0].device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(
                f"comm apply_barriered: {name} must be float32 {shape} on "
                f"{leaves[0].device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
    new_leaves = tuple(torch.empty_like(x) for x in leaves)
    new_resids = tuple(torch.empty_like(r) for r in resids)
    table = (_Leaf * len(leaves))(*(
        _Leaf(x.data_ptr(), a.data_ptr(), r.data_ptr(), m.data_ptr(), None,
              None, nx.data_ptr(), nr.data_ptr(), x[0].numel(), 0)
        for x, a, m, r, nx, nr in zip(leaves, anchors, means, resids,
                                      new_leaves, new_resids)
    ))
    alive = alive.contiguous()
    fn = _kernel("sparknet_comm_apply_barriered", (_P, _I, _I, _P, _P, _P))
    with torch.cuda.device(leaves[0].device):
        rc = fn(table, len(leaves), w, alive.data_ptr(), denom0.data_ptr(),
                _stream(leaves[0]))
    _raise_on(rc, "comm apply_barriered")
    LAUNCHES["comm_apply_barriered"] += 1
    return new_leaves, new_resids


# ----------------------------------------------------------------------
# K11: overlap correction
# ----------------------------------------------------------------------
def apply_correction_reference(leaves, anchors, qs, scales, means, modes):
    """Plain version of ``apply_correction``: ``corr = mean -
    dequant(q)`` added to params and anchor."""
    new_leaves, new_anchors = [], []
    for x, a, q, s, m, mode in zip(leaves, anchors, qs, scales, means, modes):
        if mode == "int8":
            corr = _fms(m, q, _bshape(s, q.dim()))
        elif mode in ("bf16", "fp32"):
            corr = m - q.float()
        else:
            raise ValueError(f"unknown comm mode {mode!r}")
        new_leaves.append(x + corr)
        new_anchors.append(a + corr)
    return tuple(new_leaves), tuple(new_anchors)


def apply_correction(leaves, anchors, qs, scales, means, modes):
    """Overlap correction of a comm chunk (K11)."""
    modes = tuple(modes)
    if leaves[0].device.type == "cpu":
        return apply_correction_reference(leaves, anchors, qs, scales, means,
                                          modes)
    w = _check("comm apply_correction", leaves, ("anchors", anchors, True),
               ("qs", qs, True), ("means", means, False))
    if len(modes) != len(leaves) or any(m not in MODES for m in modes):
        raise ValueError(
            f"comm apply_correction: modes {modes} for {len(leaves)} leaves"
        )
    for q, s, m in zip(qs, scales, modes):
        if q.dtype != QDTYPES[m]:
            raise TypeError(
                f"comm apply_correction: {m} payload is {q.dtype}"
            )
        if (s.dtype != torch.float32 or tuple(s.shape) != (w,)
                or s.device != q.device or not s.is_contiguous()):
            raise ValueError("comm apply_correction: scales must be "
                             "contiguous (W,) float32 on the leaves' device")
    new_leaves = tuple(torch.empty_like(x) for x in leaves)
    new_anchors = tuple(torch.empty_like(a) for a in anchors)
    table = (_Leaf * len(leaves))(*(
        _Leaf(x.data_ptr(), a.data_ptr(), None, m.data_ptr(), q.data_ptr(),
              s.data_ptr(), nx.data_ptr(), na.data_ptr(),
              x[0].numel(), MODES[mode])
        for x, a, q, s, m, nx, na, mode in zip(
            leaves, anchors, qs, scales, means, new_leaves, new_anchors, modes)
    ))
    fn = _kernel("sparknet_comm_apply_correction", (_P, _I, _I, _P))
    with torch.cuda.device(leaves[0].device):
        rc = fn(table, len(leaves), w, _stream(leaves[0]))
    _raise_on(rc, "comm apply_correction")
    LAUNCHES["comm_apply_correction"] += 1
    return new_leaves, new_anchors


def chunk_bytes(stage: str, leaves: Sequence[torch.Tensor],
                modes: Sequence[str], have: bool = True) -> int:
    """Bytes one launch must move at least, each input read once and each
    output written once — the numerator of the kernels' bound.  A
    barriered apply with survivors (``have``) needs no read of the old
    params."""
    total = 0
    for x, mode in zip(leaves, modes):
        n, per, w = x.numel(), x[0].numel(), x.shape[0]
        qb = torch.empty((), dtype=QDTYPES[mode]).element_size()
        if stage == "encode":  # x, a, r in; q, residual, scale out
            total += n * (12 + qb + 4) + 4 * w
        elif stage == "apply_barriered":  # (x or a, mean), r in; x, r out
            total += n * (12 if have else 16) + (4 * per if have else 0)
        elif stage == "apply_correction":  # x, a, q, scale, mean in; x, a out
            total += n * (16 + qb) + 4 * per + 4 * w
        else:
            raise ValueError(f"unknown stage {stage!r}")
    return total
