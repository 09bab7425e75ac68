"""sync-in-hot-path: implicit host<->device syncs in round/producer/
comm scopes (the port of ``sparknet_tpu/analysis/sync_check.py``, over
torch's sync kinds).

Flags, inside every hot scope (``hotpaths.HOT_PATHS`` plus any
thread-target function):

- ``x.item()``, ``x.tolist()``            — scalar / list D2H
- ``x.cpu()``, ``x.numpy()``, ``x.to("cpu")`` / ``x.to(device="cpu")``
  — a tensor copied to the host (the copy waits for the stream)
- ``float(x)`` / ``int(x)`` / ``bool(x)`` — implicit ``__float__``/
  ``__bool__`` D2H on a tensor (shape/len/constant reads are
  recognized as benign)
- ``np.asarray(x)`` / ``np.array(x)``     — implicit ``__array__`` D2H
- ``torch.cuda.synchronize()`` and ``<stream or event>.synchronize()``
  — an explicit host wait on the card
- ``x.nonzero()`` / ``torch.nonzero(x)``  — a data-dependent output
  shape, which the card can only report by syncing
- ``torch.tensor(x, device=d)`` / ``torch.as_tensor(x, device=d)`` — an
  H2D copy from pageable host memory, which torch makes synchronous

``jax.device_get`` and ``block_until_ready`` have no counterpart here.

Every deliberate site carries ``# sparknet: sync-ok(<reason>)`` on a
line of the flagged statement; the suppressed list stays enumerable, so
``chip_smoke.py``'s sanitizer (phase 23) can hold every sync the card
reports to an annotated site.  The checker is intentionally type-blind
(``np.asarray`` on a host array is cheap but still gets annotated — the
annotation IS the documentation that someone checked).
"""

from __future__ import annotations

import ast
from typing import Optional, Set

from sparknet_tpu_torch.analysis import astutil
from sparknet_tpu_torch.analysis.findings import (
    Finding,
    Markers,
    Report,
    Suppressed,
)

CHECKER = "sync-in-hot-path"
MARKER = "sync"

# attribute reads that mean "metadata, not data" — float()/int() over
# these never sync (shape math, sizes, python scalars)
_BENIGN_ATTRS = {
    "shape", "ndim", "size", "nbytes", "dtype", "maxlen", "start",
    "stop", "step", "itemsize", "device", "is_cuda", "requires_grad",
}
# bare-builtin calls that can be benign; METHOD calls never are —
# `float(losses.max())` is a scalar D2H reduction, exactly the careless
# sync class this checker exists to stop, and must not slip through on
# a leaf-name match
_BENIGN_NAME_CALLS = {"len", "round", "min", "max", "abs", "sum"}
# ...except tensor METADATA methods, which read the host-side header
# (`int(x.size(0))`, `x.numel()`), never the data
_BENIGN_METHODS = {
    "numel", "size", "dim", "nelement", "element_size", "stride",
    "storage_offset", "data_ptr", "get_device", "is_contiguous",
}
_NUMPY_CONVERTERS = (
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
)


def _is_benign_scalar(node: ast.AST) -> bool:
    """True when a float()/int()/bool() argument provably reads host
    metadata (constants, shape/len chains, time reads) rather than
    tensor data."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.BinOp):
        return _is_benign_scalar(node.left) and _is_benign_scalar(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_benign_scalar(node.operand)
    if isinstance(node, ast.Subscript):
        return _is_benign_scalar(node.value)
    if isinstance(node, ast.Attribute):
        if node.attr in _BENIGN_ATTRS:
            return True
        return _is_benign_scalar(node.value)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id == "len":
                return True  # len() reads shape, never data
            if fn.id in _BENIGN_NAME_CALLS:
                # max(x.shape) is benign; max(device_tensor) is a sync
                return all(_is_benign_scalar(a) for a in node.args)
        if isinstance(fn, ast.Attribute) and fn.attr in _BENIGN_METHODS:
            return True
        name = astutil.dotted(fn) or ""
        if name.startswith("time."):
            return True  # host clock reads
        return False
    if isinstance(node, ast.IfExp):
        return (_is_benign_scalar(node.body)
                and _is_benign_scalar(node.orelse))
    if isinstance(node, ast.BoolOp):
        return all(_is_benign_scalar(v) for v in node.values)
    if isinstance(node, ast.Compare):
        # a comparison of tensors yields a tensor bool — float(x > 0.5)
        # is still a sync; only shape/constant comparisons are benign
        return all(
            _is_benign_scalar(c)
            for c in [node.left] + list(node.comparators)
        )
    return False


def _is_cpu(node: Optional[ast.AST]) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if astutil.literal_str(node) == "cpu":
        return True
    return (isinstance(node, ast.Call)
            and astutil.dotted(node.func) in ("torch.device", "device")
            and bool(node.args) and astutil.literal_str(node.args[0]) == "cpu")


def _sync_kind(call: ast.Call) -> Optional[str]:
    """The sync class of a call, or None."""
    fn = call.func
    name = astutil.dotted(fn)
    bare = not call.args and not call.keywords
    if isinstance(fn, ast.Attribute):
        if name in _NUMPY_CONVERTERS:
            return name
        if name in ("torch.cuda.synchronize", "cuda.synchronize"):
            return "torch.cuda.synchronize"
        if name == "torch.nonzero":
            return "torch.nonzero"
        if name in ("torch.tensor", "torch.as_tensor"):
            dev = astutil.kwarg(call, "device")
            if dev is not None and not _is_cpu(dev):
                return f"{name}(device=)"
            return None
        if fn.attr in ("item", "tolist", "cpu", "numpy") and bare:
            return f".{fn.attr}()"
        if fn.attr == "synchronize":
            return ".synchronize()"
        if fn.attr == "nonzero":
            return ".nonzero()"
        if fn.attr == "to" and (
            (call.args and _is_cpu(call.args[0]))
            or _is_cpu(astutil.kwarg(call, "device"))
        ):
            return ".to(cpu)"
    elif isinstance(fn, ast.Name):
        if fn.id in ("float", "int", "bool") and len(call.args) == 1:
            if not _is_benign_scalar(call.args[0]):
                return f"{fn.id}()"
    return None


def check_module(
    tree: ast.Module,
    relpath: str,
    markers: Markers,
    hot_scopes: Set[str],
    thread_targets: Set[str],
) -> Report:
    rep = Report()
    funcs = astutil.collect_functions(tree)

    def walk_scope(node, qual):
        """Like ast.walk, but a nested def that is ITSELF a hot scope
        or thread target is skipped — it gets its own visit under its
        own qualname (no double-count).  Other nested closures stay in:
        they run in the hot scope that defines them."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, astutil.FUNC_NODES):
                if (
                    f"{qual}.{child.name}" in hot_scopes
                    or child.name in thread_targets
                ):
                    continue
                yield from walk_scope(child, f"{qual}.{child.name}")
                continue
            yield child
            yield from walk_scope(child, qual)

    for qual, node in funcs.items():
        leaf = qual.split(".")[-1]
        if qual not in hot_scopes and leaf not in thread_targets:
            continue
        for sub in walk_scope(node, qual):
            if isinstance(sub, ast.Call):
                kind = _sync_kind(sub)
                if kind is None:
                    continue
                lo, hi = astutil.span_lines(sub)
                msg = (
                    f"{kind} syncs host<->device inside hot path "
                    f"'{qual}'"
                )
                reason = markers.covers(MARKER, lo, hi)
                if reason is not None:
                    rep.suppressed.append(Suppressed(
                        CHECKER, relpath, lo, qual, msg, reason, hi,
                    ))
                else:
                    rep.findings.append(Finding(
                        checker=CHECKER, path=relpath, line=lo,
                        scope=qual, message=msg,
                        fixit="move the read off the steady-state round "
                        "path, or annotate the line with "
                        "# sparknet: sync-ok(<why this sync is "
                        "deliberate>)",
                    ))
    return rep
