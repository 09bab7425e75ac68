"""Carry weights from the JAX package's layout into the port's modules.

``net_params_from_jax`` carries a prototxt net's ``{layer: [blob,
...]}`` dicts into the port's ``TorchNet`` layout (the same layouts,
checked).  The JAX ``TransformerLM`` keeps its parameters as ``{group: [blob,
...]}`` in ``_blob_plan`` order (``embed``, ``block{i}_ln1``,
``block{i}_attn``, ``block{i}_ln2``, ``block{i}_mlp``, ``ln_f``,
``head``); the port's serving module keeps them as named submodules
(``lm_state_from_jax``) and its training net as the same dict
(``lm_params_from_jax``).  Both store matrices as (in, out) for
``x @ w``, so carrying a blob across is a copy — this module is the one
place that knows both layouts.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def lm_state_from_jax(
    params: Mapping[str, Sequence[np.ndarray]], lm,
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter dict.

    ``lm`` is a port ``TransformerLM`` of the same geometry; its group
    plan names the blobs.  Load the result with
    ``lm.load_state_dict(state)`` (it copies onto the module's device).
    Blobs may be numpy arrays or anything ``np.asarray`` takes."""
    groups = lm.group_params()
    names = {id(p): n for n, p in lm.named_parameters()}
    state: Dict[str, torch.Tensor] = {}
    for group, shapes in lm._blob_plan():
        blobs = params[group]
        if len(blobs) != len(shapes):
            raise ValueError(
                f"group {group!r}: {len(blobs)} blobs, expected {len(shapes)}"
            )
        for bi, (blob, shape, p) in enumerate(
            zip(blobs, shapes, groups[group])
        ):
            arr = np.asarray(blob, dtype=np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(
                    f"{group}[{bi}]: shape {arr.shape}, expected {shape}"
                )
            state[names[id(p)]] = torch.from_numpy(arr.copy())
    return state


def lm_params_from_jax(
    params: Mapping[str, Sequence[np.ndarray]], lm, device=None,
) -> Dict[str, List[torch.Tensor]]:
    """The port's ``{group: [tensor]}`` solver params for a JAX LM
    parameter dict, on ``device``.  ``lm`` is a port ``TransformerLMNet``
    (or ``TransformerLM``) of the same geometry; groups, blob counts and
    shapes are checked against its plan."""
    plan = lm._blob_plan()
    if set(params) != {g for g, _ in plan}:
        raise ValueError(
            f"groups {sorted(params)}, the LM has {sorted(g for g, _ in plan)}"
        )
    out: Dict[str, List[torch.Tensor]] = {}
    for group, shapes in plan:
        blobs = params[group]
        if len(blobs) != len(shapes):
            raise ValueError(
                f"group {group!r}: {len(blobs)} blobs, expected {len(shapes)}"
            )
        out[group] = []
        for bi, (blob, shape) in enumerate(zip(blobs, shapes)):
            arr = np.asarray(blob, dtype=np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(
                    f"{group}[{bi}]: shape {arr.shape}, expected {shape}"
                )
            out[group].append(torch.from_numpy(arr.copy()).to(device))
    return out


def net_params_from_jax(
    params: Mapping[str, Sequence[np.ndarray]],
    net,
    stats: Optional[Mapping[str, Sequence[np.ndarray]]] = None,
    device=None,
) -> Tuple[Dict[str, List[torch.Tensor]], Dict[str, List[torch.Tensor]]]:
    """The port's ``(params, stats)`` for a JAX net's parameter dicts.

    The JAX package's prototxt nets keep ``{layer: [blob, ...]}`` in the
    reference's Caffe layouts — Convolution ``(out, in/group, kh, kw)``,
    InnerProduct ``(out, in)`` — which are the port's layouts too, so
    every blob is a copy.  ``net`` is the port's ``TorchNet`` of the same
    prototxt; the layer names, blob counts and shapes are checked against
    its layout.  ``stats`` may be omitted for nets without stat blobs."""

    def carry(src, layout, what):
        src = dict(src or {})
        if set(src) != set(layout):
            raise ValueError(
                f"{what}: layers {sorted(src)}, the net has {sorted(layout)}"
            )
        out: Dict[str, List[torch.Tensor]] = {}
        for layer, shapes in layout.items():
            blobs = src[layer]
            if len(blobs) != len(shapes):
                raise ValueError(
                    f"{what} {layer!r}: {len(blobs)} blobs, expected "
                    f"{len(shapes)}"
                )
            out[layer] = []
            for bi, (blob, shape) in enumerate(zip(blobs, shapes)):
                arr = np.asarray(blob, dtype=np.float32)
                if arr.shape != tuple(shape):
                    raise ValueError(
                        f"{what} {layer}[{bi}]: shape {arr.shape}, "
                        f"expected {tuple(shape)}"
                    )
                out[layer].append(torch.from_numpy(arr.copy()).to(device))
        return out

    return (carry(params, net.blob_layout("params"), "params"),
            carry(stats, net.blob_layout("stats"), "stats"))
