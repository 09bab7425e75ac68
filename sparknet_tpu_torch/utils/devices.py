"""Device selection, and the card's identity for printouts.

The port's entry points run on the card unless the caller asks for the
CPU: ``resolve_device(None)`` is ``cuda``, and asking for CUDA where
there is no CUDA device raises — nothing continues quietly on the CPU.
``with deterministic_algorithms():`` pins, for its block, the algorithm
choices a resumable training run needs to repeat itself bit for bit on
the card.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from typing import Iterator, Optional, Union

import torch
from torch.utils import deterministic as _torch_deterministic


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


# the cuBLAS workspace settings under which cuBLAS promises run-to-run
# reproducibility (the CUDA toolkit's cuBLAS "Results reproducibility")
_CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True) -> Iterator[None]:
    """Within the block, every op of this process picks deterministic
    algorithms (``on``) or torch's defaults (``on=False``); the flags
    before it come back on exit.  On:
    ``torch.use_deterministic_algorithms(True)`` (strict: an op with no
    deterministic CUDA version raises), cuDNN deterministic with its
    autotuner off, and ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless a
    deterministic setting is already there.  ``torch.empty`` is not
    filled with NaN (``fill_uninitialized_memory``, a debugging aid that
    no algorithm choice needs).  cuBLAS reads the variable when it first
    runs, so the variable stays set after the block, and the block must
    open before the process's first CUDA matmul.  The training entry
    points that can resume (``apps.lm_app``, ``cli train``) run inside
    it on every run, resumed or not, so that both take the same
    algorithms."""
    if on and os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in \
            _CUBLAS_DETERMINISTIC:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = _CUBLAS_DETERMINISTIC[0]
    saved = (
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
        torch.backends.cudnn.deterministic,
        torch.backends.cudnn.benchmark,
        _torch_deterministic.fill_uninitialized_memory,
    )
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
    _torch_deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det, warn_only, cudnn_det, benchmark, fill = saved
        torch.use_deterministic_algorithms(det, warn_only=warn_only)
        torch.backends.cudnn.deterministic = cudnn_det
        torch.backends.cudnn.benchmark = benchmark
        _torch_deterministic.fill_uninitialized_memory = fill
