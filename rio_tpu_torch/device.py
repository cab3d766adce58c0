"""Device resolution and the float32 policy of the port.

Every public entry point of :mod:`rio_tpu_torch` runs on the CUDA device
unless its caller passes ``device="cpu"``. With no CUDA device and no
explicit ``"cpu"`` it raises: a run that asked for the card never drops to
the CPU quietly.

TF32 is switched off for matrix products and cuDNN, so float32 stays
float32 on the card as it does on the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises ``RuntimeError`` when ``device`` is None and no CUDA device is
    present, or when a CUDA device is named and none is present.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rio_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for and CUDA is not available")
    return dev
