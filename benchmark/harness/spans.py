"""``bench.*`` host spans around calls into the program's layers."""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    """Each span is a ``record_function`` scope (read from the trace);
    while ``timed`` it is also fenced by ``torch.cuda.synchronize()`` on
    both sides and its seconds are kept by name."""

    def __init__(self, device):
        self.device = device
        self.timed = False
        self.seconds = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, spanned)

    @contextlib.contextmanager
    def span(self, name):
        from torch.profiler import record_function

        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        with record_function(name):
            yield
        if self.timed:
            self._sync()
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - t0)
