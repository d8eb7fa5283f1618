"""Seeded reprolint violations of the port's device path (kernels/).

NEVER import this: it exists only to be parsed by
tests/test_torch_analysis_lint.py.  Expected: RL001, RL002, RL003, RL007.
"""
import numpy as np
import torch


def bad_host_numpy(x):
    return np.exp(x) + x                 # RL001: host numpy on the device path


def bad_item_sync(x):
    return (x * 2).sum().item()          # RL002: host sync


def bad_python_branch(x):
    if torch.any(x > 0):                 # RL003: branch on a device value
        return x
    return -x


def bad_f64(x):
    return x.to(torch.float64)           # RL007: f64 dtype request


def fine(x):
    if torch.is_grad_enabled() and x.dim() == 2:     # host queries
        return torch.where(x > 0, x, -x)
    return x
