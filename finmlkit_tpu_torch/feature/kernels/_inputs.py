"""Inputs of the feature kernels as float64 (or int64) tensors on one device.

The port's stand-in for ``finmlkit_tpu/config.py``: the working dtype is
always float64, since the card computes float64 natively. A tensor input stays
on its device; numpy arrays and lists go to the device of the first tensor
among the inputs, else to the ``device`` argument.
"""
import numpy as np
import torch


def device_of(device, *xs) -> torch.device:
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return torch.device(device)


def f64(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(device)


def i64(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)


def nan_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float("nan"))
