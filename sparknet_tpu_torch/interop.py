"""Carry weights from the JAX package's layout into the port's modules.

The JAX ``TransformerLM`` keeps its parameters as ``{group: [blob,
...]}`` in ``_blob_plan`` order (``embed``, ``block{i}_ln1``,
``block{i}_attn``, ``block{i}_ln2``, ``block{i}_mlp``, ``ln_f``,
``head``); the port keeps them as named submodules.  Both store
matrices as (in, out) for ``x @ w``, so carrying a blob across is a
copy — this module is the one place that knows both layouts.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

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
