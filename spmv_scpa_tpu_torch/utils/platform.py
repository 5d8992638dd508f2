"""Device helpers.

The port runs on the card. A ``prepare`` takes its device explicitly,
``"cuda"`` by default, and raises when there is no card rather than
fall back: the CPU runs the kernels' plain PyTorch versions, and only
when it is asked for by name.
"""

from __future__ import annotations

import subprocess

import torch


def cuda_device(index: int = 0) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's kernels run on an NVIDIA card; "
            "pass device='cpu' to run their plain PyTorch versions")
    return torch.device("cuda", index)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return cuda_device(0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
