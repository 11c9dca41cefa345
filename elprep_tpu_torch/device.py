"""Compute-device selection for the port.

Every entry point runs on ``cuda`` unless its caller asks for the CPU:
library functions take ``device=`` (``None`` means the session default),
and the CLI sets the session default from ``ELPREP_TPU_TORCH_DEVICE``
(default ``cuda``). Asking for ``cuda`` where PyTorch sees no card
raises; nothing carries on on the CPU instead.
"""

from __future__ import annotations

import os

import torch

ENV_VAR = "ELPREP_TPU_TORCH_DEVICE"

_DEFAULT = ["cuda"]


class DeviceUnavailable(RuntimeError):
    """The requested compute device does not exist in this process."""


def set_default_device(device) -> torch.device:
    """Resolve ``device`` and make it the session default."""
    dev = resolve(device)
    _DEFAULT[0] = str(dev)
    return dev


def default_device_from_env() -> torch.device:
    """Session default from ``ELPREP_TPU_TORCH_DEVICE`` (``cuda`` when unset)."""
    return set_default_device(os.environ.get(ENV_VAR, "").strip() or "cuda")


def resolve(device=None) -> torch.device:
    """``device`` (or the session default) as a checked torch.device."""
    dev = torch.device(_DEFAULT[0] if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "cuda not available: torch.cuda.is_available() is false in this "
            f"process; set {ENV_VAR}=cpu (or pass device='cpu') to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {dev}")
    return dev
