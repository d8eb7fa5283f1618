"""``torch.func``'s wrapper levels, for ``autograd.Function``s with
hand-written derivatives: the sLSTM scan and the RG-LRU linear scan
(``models.blocks``) and the windowed attention kernels
(``kernels.swa_attention``).

``torch.func.jvp`` hands a custom jvp its tangents and saved tensors
wrapped at its level, and ``torch.func.vjp`` a custom backward its
cotangents and saved tensors wrapped at its own.  Every operation on a
wrapped tensor passes through ``torch.func``'s dispatch, a wrapped tensor
has no ``data_ptr()`` a kernel could read, and a CUDA graph cannot capture
it.  ``unwrap_one_level`` strips that one level, ``outside_transforms``
runs the derivative's operations as plain PyTorch, and ``rewrap`` puts a
result back at the level.  These are private ``torch._C._functorch`` calls; a
PyTorch upgrade may change them, and the tests of the scans and of the
attention's derivatives would fail first.

The derivatives these Functions compute read their saved tensors as
constants, so they are right to first order only: ``first_order_only``
raises when one would run under a further transform.
"""
from __future__ import annotations

import torch
from torch._C import _functorch


def wrapped(t) -> bool:
    return _functorch.is_functorch_wrapped_tensor(t)


def unwrap_one_level(tensors):
    """Returns the tensors with their outermost ``torch.func`` level's
    wrapper removed, and that level; or the tensors and None when none is
    wrapped (None entries pass through).  The level is the derivative's
    own transform's: the live level of a jvp or of a backward run inside
    ``torch.func.grad``, or an ended one (a ``torch.func.vjp`` pullback
    called after ``vjp`` returned sees its saved tensors wrapped at a
    level that no longer exists; None is returned then, and nothing is
    rewrapped).  A tensor the transform did not reach (a constant) is not
    wrapped and passes as it is; one wrapped at two levels keeps the inner
    one, which ``first_order_only`` then refuses."""
    tops = [_functorch.maybe_get_level(t) if t is not None and wrapped(t)
            else None for t in tensors]
    if any(top is not None and top < 0 for top in tops):
        return tuple(_functorch.get_unwrapped(t)
                     if top is not None and top < 0 else t
                     for t, top in zip(tensors, tops)), None
    live = [top for top in tops if top is not None]
    if not live:
        return tuple(tensors), None
    level = max(live)
    return tuple(_functorch._unwrap_for_grad(t, level) if top == level
                 else t for t, top in zip(tensors, tops)), level


def outside_transforms():
    """A context in which operations on unwrapped tensors run as plain
    PyTorch: without it, an operation inside a custom jvp or backward is
    still lifted to the live level and dispatched through ``torch.func``
    (and a kernel launched by ``torch.library`` would see it so)."""
    return torch._C._DisableFuncTorch()


def rewrap(t, level):
    """``t``, computed ``outside_transforms`` from tensors of
    ``unwrap_one_level``, wrapped at ``level`` again, or ``t`` itself when
    ``level`` is None."""
    if level is None or t is None:
        return t
    return _functorch._wrap_for_grad(t, level)


def first_order_only(tensors, own: int, what: str) -> None:
    """Raises when a hand-written derivative of ``what`` would run under a
    further transform: when a tensor has more ``torch.func`` wrappers than
    the derivative's own transform leaves (``own``: none in a jvp that
    removed its own, one in a backward), or when autograd records the
    tensor inside it (a double backward)."""
    for t in tensors:
        if t is None:
            continue
        wrappers = 0
        while wrapped(t):
            wrappers, t = wrappers + 1, _functorch.get_unwrapped(t)
        if wrappers > own or (torch.is_grad_enabled() and t.requires_grad):
            raise NotImplementedError(
                f"the {what}'s derivatives are first-order only: a jvp or "
                f"vjp of them cannot itself be differentiated")
