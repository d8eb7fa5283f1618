"""Capture hook for the kernel sanitizer.

Port of ``repro.kernels.instrument``.  The reference wraps
``pl.pallas_call``; here every kernel wrapper calls :func:`record` just
before its ``build.launch`` (``route="cuda"``), and its CPU route calls
it just before returning the plain version (``route="plain"``) with the
launcher the card would run, the same launch plan and the same index
operands.  Inside ``capture_calls()`` each call appends a
:class:`KernelCall`: the launcher (``dag_forward_launch`` ...), its
library stem (``lattice_dag`` ...), the route, the launch configuration
the host chose (threads, dynamic shared bytes, ``gstride``, tile
geometry, the grid where the host computes it) and the named tensor
operands.  ``repro_torch.analysis.rules_kernel`` checks them; on the CPU
KS003 thus sees exactly the index tensors the kernel would gather with.

Outside a capture, :func:`record` is one ``is None`` test: it changes no
launch, no launch count and no route.  While a capture is open,
``kernels.build.launch`` also counts its own calls
(:func:`count_launch`, read as ``launches``), so a card run can assert
that the records of the ``"cuda"`` route equal the launches, and that
no launch slipped past the hook.

Capture is process-global and not thread-safe: it exists for the
sanitizer and tests, which run the kernels serially.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class KernelCall:
    """One captured launch (see the module docstring)."""

    name: str                     # the launcher: "dag_forward_launch" ...
    stem: str                     # its library: "lattice_dag" ...
    route: str                    # "cuda" or "plain"
    config: Dict = field(default_factory=dict)
    operands: Dict = field(default_factory=dict)   # name -> tensor

    @property
    def shapes(self) -> Dict[str, tuple]:
        return {k: tuple(t.shape) for k, t in self.operands.items()}


class Capture(list):
    """The records of one ``capture_calls()`` block; ``launches`` counts
    the ``build.launch`` calls made while it was the innermost capture."""

    launches: int = 0


_RECORDS: Optional[Capture] = None


@contextlib.contextmanager
def capture_calls():
    """Collect a :class:`KernelCall` per launch inside the block."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, Capture()
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def capturing() -> bool:
    """Whether a capture is open (for a record whose arguments cost more
    than the launch's own values to build)."""
    return _RECORDS is not None


def record(stem: str, name: str, route: str, config: dict,
           **operands) -> None:
    """Append one :class:`KernelCall` to the open capture, if any."""
    if _RECORDS is None:
        return
    _RECORDS.append(KernelCall(name, stem, route, dict(config), operands))


def count_launch() -> None:
    """Called by ``build.launch`` for every launch it makes."""
    if _RECORDS is not None:
        _RECORDS.launches += 1

