"""Where an entry point's input goes: a tensor stays on its own device
unless the caller names another, a numpy array goes to the card unless the
caller names another (``device="cpu"`` runs the plain PyTorch ops)."""

import numpy as np
import torch


def as_f32(x, device=None):
    """``x`` as a float32 tensor on ``device`` (see the module docstring)."""
    if isinstance(x, torch.Tensor):
        return x.to(device or x.device, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device or "cuda")


def target_device(x, device=None):
    """The device :func:`as_f32` would put ``x`` on."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cuda")


def host_f32(x):
    """``x`` as a float32 numpy array; a tensor is copied to the host (for
    entry points whose host code, framing or geometry, runs in numpy)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
