"""Small AST helpers shared by the checkers: qualname-indexed function
collection, dotted-name rendering, and thread-target discovery (a copy
of ``sparknet_tpu/analysis/astutil.py``, which the port does not import)."""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set

FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted(node: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` / ``self._x`` attribute chains (None for
    anything fancier — subscripts, calls)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def collect_functions(tree: ast.Module) -> Dict[str, ast.AST]:
    """``qualname -> def node`` for every (possibly nested) function;
    nesting joins with ``.`` (``Class.method``, ``outer.inner``)."""
    out: Dict[str, ast.AST] = {}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FUNC_NODES):
                qn = f"{prefix}.{child.name}" if prefix else child.name
                out[qn] = child
                walk(child, qn)
            elif isinstance(child, ast.ClassDef):
                qn = f"{prefix}.{child.name}" if prefix else child.name
                walk(child, qn)
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def is_thread_ctor(call: ast.Call) -> bool:
    """``threading.Thread(...)`` / ``Thread(...)``."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        return True
    return isinstance(fn, ast.Name) and fn.id == "Thread"


def thread_target_names(tree: ast.Module) -> Set[str]:
    """Local function names passed as ``target=`` to a Thread ctor
    anywhere in the module (these scopes run on framework threads)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and is_thread_ctor(node):
            for kw in node.keywords:
                if kw.arg == "target":
                    name = dotted(kw.value)
                    if name:
                        out.add(name.split(".")[-1])
    return out


def kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def span_lines(node: ast.AST) -> tuple:
    return node.lineno, getattr(node, "end_lineno", node.lineno)
