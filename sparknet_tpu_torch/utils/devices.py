"""Device selection, and the card's identity for printouts.

The port's entry points run on the card unless the caller asks for the
CPU: ``resolve_device(None)`` is ``cuda``, and asking for CUDA where
there is no CUDA device raises — nothing continues quietly on the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device=cpu on the CLI) to run on the CPU"
        )
    return dev


def card_name_and_power_limit(index: int = 0) -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for one card — the
    label every timing printed by the port stands beside."""
    out = subprocess.run(
        [
            "nvidia-smi", f"--id={int(index)}",
            "--query-gpu=name,power.limit", "--format=csv,noheader",
        ],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
