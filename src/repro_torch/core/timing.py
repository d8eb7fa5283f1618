"""Stage timing of an update: host-clock totals per named stage.

``SecondOrderOptimizer.timer`` (None by default, then nothing is timed
and nothing synchronizes) takes a :class:`StageTimer`.  Each timed
section starts and ends with ``torch.cuda.synchronize()`` on a CUDA
device, so its total is the device work of that stage; the syncs are
the instrumentation's cost and change the overlap of host and device,
so an update timed this way is slower than an untimed one.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class StageTimer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.totals = defaultdict(float)     # stage -> seconds
        self.calls = defaultdict(int)        # stage -> sections timed

    def _sync(self):  # reprolint: host: a timer waits for the card
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def wrap(self, name: str, fn):
        """``fn`` with every call timed as a ``name`` section."""
        def timed(*args, **kwargs):
            with self.section(name):
                return fn(*args, **kwargs)
        return timed

    def reset(self):
        self.totals.clear()
        self.calls.clear()
