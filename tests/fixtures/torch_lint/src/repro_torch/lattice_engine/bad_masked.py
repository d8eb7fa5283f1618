"""Seeded RL006 violations: raw reductions over masked arc axes.

Parsed, never imported (tests/test_torch_analysis_lint.py).
"""
import torch


def bad_raw_logsumexp(scores):
    # RL006: an all-masked row gives -inf and NaN gradients
    return torch.logsumexp(scores, dim=-1)


def bad_raw_softmax(scores):
    return scores.softmax(-1)            # RL006


def masked_logsumexp(scores, mask):
    # the sanctioned helper itself may reduce raw
    return torch.logsumexp(torch.where(mask, scores, -1e30), dim=-1)
