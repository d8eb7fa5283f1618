"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without
a card that default raises instead of carrying on on the CPU: a caller
who wants the CPU (the tests, a laptop smoke run) says so.  The device
of the tensors then decides the path below: tensors on a CUDA device go
through the hand-written kernels, tensors on the CPU through their plain
PyTorch versions.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def set_numerics() -> None:
    """Full-f32 products on the card: TF32 off for matmul and cuDNN.

    The acoustic models and their curvature products are held against
    f32 references (TF32 keeps about three decimal digits, and the GN
    products would drift from the reference), and the cuDNN default is
    TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is present,
    and ``ValueError`` for a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch.cuda.is_available() is "
                f"False; pass device='cpu' to run the plain PyTorch path")
        set_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; expected "
                         f"'cuda' (default) or 'cpu'")
    return dev
