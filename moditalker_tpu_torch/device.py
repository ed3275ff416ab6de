"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without a
card they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is present); anything else is
    taken as given. On a CUDA device, TF32 is switched off for float32
    matmuls and convolutions: the card computes the model in bf16, and
    what runs in float32 (schedules, the DDIM update, fp32 comparisons)
    runs in full float32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
