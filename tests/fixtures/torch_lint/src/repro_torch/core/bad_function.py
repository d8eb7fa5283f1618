"""Seeded RL005 violations: an autograd.Function without a backward and
a custom op without a fake.

Parsed, never imported (tests/test_torch_analysis_lint.py).
"""
import torch


class Forgotten(torch.autograd.Function):   # RL005: no backward
    @staticmethod
    def forward(ctx, x):
        return x.tanh()


class Registered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.tanh()

    @staticmethod
    def backward(ctx, g):
        return g


@torch.library.custom_op("fixture::unfaked", mutates_args=())
def unfaked(x: torch.Tensor) -> torch.Tensor:   # RL005: no register_fake
    return x.clone()


@torch.library.custom_op("fixture::faked", mutates_args=())
def faked(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@faked.register_fake
def _(x):
    return torch.empty_like(x)
