"""Donation discipline, the torch counterpart: a buffer handed to the
device asynchronously must not be written again before the device is
done reading it.

The JAX checker (``sparknet_tpu/analysis/donation_check.py``) polices
``jax.jit(..., donate_argnums=...)``: a donated buffer is deleted, and
touching it again raises on a real chip.  Torch has no donation; the
same bug there is silent.  ``dst.copy_(src, non_blocking=True)`` and
``src.to(device, non_blocking=True)`` return before the copy has read
``src`` (from pinned memory the host does not wait at all), so a write
into ``src`` before the copy lands changes what the device receives —
and on the CPU, where ``torch.from_numpy`` shares memory, the "device"
batch IS the host array.  This module keeps the JAX checker's file
name, checker name and ``donation-ok`` marker so that a reader finds
the counterpart; "donated" here reads "handed over".

A name is handed over when it is

- the source of ``.copy_(src, non_blocking=True)``;
- the receiver of ``.to(..., non_blocking=True)`` / ``.cuda(...,
  non_blocking=True)``, directly or through ``.pin_memory()`` (which
  returns the tensor itself when it is pinned already: a pinned staging
  buffer);
- passed in a registered position of a known async producer
  (``KNOWN_ASYNC``, the counterpart of ``KNOWN_DONATING``).

It is written by an in-place tensor method (``x.add_(...)``, any
``<name>_`` method), ``x[...] = ...``, ``x += ...``, ``np.copyto(x,
...)`` (or into its numpy view, ``np.copyto(x.numpy(), ...)``) and any
``out=x`` argument.  A ``synchronize()``, ``wait_stream`` or event wait
(``wait_event``, ``ev.wait()``) in the same function ends every
hand-over, and rebinding the name starts a fresh buffer.

Two reuse shapes are caught, intraprocedurally, as in the JAX checker:

1. straight-line: ``dev = buf.to(d, non_blocking=True); buf[...] = 0``;
2. loop-carried — the classic one: a staging buffer built once OUTSIDE
   the loop, refilled at the top of each iteration and copied
   ``non_blocking`` at its end, so iteration 2 overwrites a buffer
   iteration 1's copy may still be reading.

The analysis is a small abstract interpreter over each function body:
``inflight`` maps name -> hand-over line; writes of an in-flight name
report, stores revive, waits clear.  ``if``/``try`` branches fork the
state and merge by union (possibly-in-flight is worth reporting); loop
bodies run twice so the second pass models the next iteration.

Suppression: ``# sparknet: donation-ok(<reason>)`` on the writing
statement (legit when the source was pageable, so the copy finished
before the call returned, or the device side is known to be done).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from sparknet_tpu_torch.analysis import astutil
from sparknet_tpu_torch.analysis.findings import (
    Finding,
    Markers,
    Report,
    Suppressed,
)

CHECKER = "donation-discipline"
MARKER = "donation"

# the framework's async producers, by callable name: the positions whose
# argument the device (or the returned batch) still reads after the call
# returns.  ``data/prefetch.py``'s ``place_batch(host, device, stream)``
# hands ``host`` over until its event: on the card the copies run from
# pinned staging on a side stream, on the CPU the returned tensors share
# the arrays' memory
KNOWN_ASYNC: Dict[str, Tuple[int, ...]] = {
    "place_batch": (0,),
}

_WAITS = ("synchronize", "wait_stream", "wait_event")


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _root_name(node: ast.AST) -> Optional[str]:
    """``x`` for ``x``, ``x[k]`` (an array a dict or list of them holds),
    ``x.pin_memory()`` and ``x.numpy()`` (a pinned tensor's
    ``pin_memory()`` is itself; ``numpy()`` is a view)."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in ("pin_memory", "numpy")
              and not node.args):
            node = node.func.value
        else:
            return node.id if isinstance(node, ast.Name) else None


def _handed_over(call: ast.Call, producers: Dict[str, Tuple[int, ...]]
                 ) -> List[str]:
    fn = call.func
    out: List[str] = []
    if isinstance(fn, ast.Attribute):
        if fn.attr == "copy_" and call.args and _is_true(
                astutil.kwarg(call, "non_blocking")):
            name = _root_name(call.args[0])
            if name:
                out.append(name)
        if fn.attr in ("to", "cuda") and _is_true(
                astutil.kwarg(call, "non_blocking")):
            name = _root_name(fn.value)
            if name:
                out.append(name)
    callee = astutil.dotted(fn)
    leaf = callee.split(".")[-1] if callee else None
    for p in producers.get(leaf, ()) if leaf else ():
        if p < len(call.args) and isinstance(call.args[p], ast.Name):
            out.append(call.args[p].id)
    return out


def _written(call: ast.Call) -> List[Tuple[str, ast.AST]]:
    """The names a call writes into, each with the node to report at."""
    fn = call.func
    out: List[Tuple[str, ast.AST]] = []
    if (isinstance(fn, ast.Attribute) and fn.attr.endswith("_")
            and not fn.attr.startswith("_")):
        name = _root_name(fn.value)
        if name:
            out.append((name, call))
    if astutil.dotted(fn) in ("np.copyto", "numpy.copyto") and call.args:
        name = _root_name(call.args[0])
        if name:
            out.append((name, call))
    kw = astutil.kwarg(call, "out")
    if kw is not None:
        name = _root_name(kw)
        if name:
            out.append((name, call))
    return out


def _is_wait(call: ast.Call) -> bool:
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr in _WAITS:
        return True
    # ``ev.wait()`` / ``ev.wait(stream)``: an event wait (a
    # ``threading.Event.wait(timeout)`` also ends the hand-over —
    # type-blind, and harmless: the checker only under-reports there)
    return fn.attr == "wait"


class _Scope:
    """One function's interpretation: in-flight tracking + reporting."""

    def __init__(self, qual: str, relpath: str, markers: Markers,
                 producers: Dict[str, Tuple[int, ...]], rep: Report):
        self.qual = qual
        self.relpath = relpath
        self.markers = markers
        self.producers = producers
        self.rep = rep
        self.reported: Set[Tuple[str, int]] = set()

    # ---- expression walk: writes check, copies hand over, waits clear --
    def expr(self, node: ast.AST, inflight: Dict[str, int]) -> None:
        if isinstance(node, ast.Call):
            self.expr(node.func, inflight)
            for a in node.args:
                self.expr(a, inflight)
            for kw in node.keywords:
                self.expr(kw.value, inflight)
            if _is_wait(node):
                inflight.clear()
                return
            for name, at in _written(node):
                self._check_write(name, at, inflight)
            for name in _handed_over(node, self.producers):
                inflight[name] = node.lineno
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # separate scope
        for child in ast.iter_child_nodes(node):
            self.expr(child, inflight)

    def _check_write(self, name: str, at: ast.AST,
                     inflight: Dict[str, int]) -> None:
        if name not in inflight:
            return
        key = (name, at.lineno)
        if key in self.reported:
            return
        self.reported.add(key)
        # the hand-over line stays OUT of the message: Finding.key is
        # the allowlist baseline key and must not shift with the file
        msg = (
            f"'{name}' written while a non_blocking copy may still read "
            "it (no synchronize or stream/event wait since the hand-over)"
        )
        lo, hi = astutil.span_lines(at)
        reason = self.markers.covers(MARKER, lo, hi)
        if reason is not None:
            self.rep.suppressed.append(Suppressed(
                CHECKER, self.relpath, lo, self.qual, msg, reason, hi,
            ))
        else:
            self.rep.findings.append(Finding(
                checker=CHECKER, path=self.relpath, line=lo,
                scope=self.qual, message=msg,
                fixit="write into a fresh buffer (or one per round in "
                "flight), wait on the copy's event first, or annotate "
                "with # sparknet: donation-ok(<why the copy is done>)",
            ))

    # ---- statement walk -------------------------------------------------
    def stores(self, tgt: ast.AST, inflight: Dict[str, int]) -> None:
        if isinstance(tgt, ast.Name):
            inflight.pop(tgt.id, None)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self.stores(el, inflight)
        elif isinstance(tgt, ast.Starred):
            self.stores(tgt.value, inflight)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            # storing INTO x[i] writes x; into x.attr rebinds an
            # attribute of x, not its data
            if isinstance(tgt, ast.Subscript):
                name = _root_name(tgt.value)
                if name:
                    self._check_write(name, tgt, inflight)
                self.expr(tgt.slice, inflight)
            self.expr(tgt.value, inflight)

    def block(self, body: List[ast.stmt], inflight: Dict[str, int]) -> None:
        for stmt in body:
            self.stmt(stmt, inflight)

    def stmt(self, stmt: ast.stmt, inflight: Dict[str, int]) -> None:
        if isinstance(stmt, ast.Assign):
            self.expr(stmt.value, inflight)
            for t in stmt.targets:
                self.stores(t, inflight)
        elif isinstance(stmt, ast.AugAssign):
            self.expr(stmt.value, inflight)
            tgt = stmt.target
            name = _root_name(tgt.value if isinstance(tgt, ast.Subscript)
                              else tgt)
            if name:
                # x += y is in place for a tensor or an array
                self._check_write(name, stmt, inflight)
            if isinstance(tgt, ast.Subscript):
                self.expr(tgt.slice, inflight)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.expr(stmt.value, inflight)
            self.stores(stmt.target, inflight)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.expr(stmt.iter, inflight)
            for _pass in range(2):   # second pass = next iteration
                self.stores(stmt.target, inflight)
                self.block(stmt.body, inflight)
            self.block(stmt.orelse, inflight)
        elif isinstance(stmt, ast.While):
            for _pass in range(2):
                self.expr(stmt.test, inflight)
                self.block(stmt.body, inflight)
            self.block(stmt.orelse, inflight)
        elif isinstance(stmt, ast.If):
            self.expr(stmt.test, inflight)
            d_then = dict(inflight)
            self.block(stmt.body, d_then)
            d_else = dict(inflight)
            self.block(stmt.orelse, d_else)
            inflight.clear()
            inflight.update(d_else)
            inflight.update(d_then)   # union: possibly-in-flight reports
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.expr(item.context_expr, inflight)
                if item.optional_vars is not None:
                    self.stores(item.optional_vars, inflight)
            self.block(stmt.body, inflight)
        elif isinstance(stmt, ast.Try):
            self.block(stmt.body, inflight)
            post_body = dict(inflight)
            for h in stmt.handlers:
                d_h = dict(post_body)
                self.block(h.body, d_h)
                inflight.update(d_h)
            self.block(stmt.orelse, inflight)
            self.block(stmt.finalbody, inflight)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass  # separate scope; visited on its own
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.expr(child, inflight)
                elif isinstance(child, ast.stmt):
                    self.stmt(child, inflight)


def check_module(tree: ast.Module, relpath: str, markers: Markers) -> Report:
    rep = Report()
    for qual, fn in astutil.collect_functions(tree).items():
        scope = _Scope(qual, relpath, markers, KNOWN_ASYNC, rep)
        scope.block(fn.body, {})
    return rep
