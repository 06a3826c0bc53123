"""Wall-clock timing (context manager), reference ``utils/timer.py``.

CUDA work is asynchronous: callers pass results through :func:`synchronize`
before reading ``elapsed()``.
"""

import time

import torch


def synchronize(x):
    """Wait for the device work producing tensor ``x``; returns ``x``."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


class Timer:
    def __init__(self):
        self._t0 = None
        self._t1 = None

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._t1 = time.perf_counter_ns()
        return False

    def elapsed(self):
        """Elapsed seconds between enter and exit (or now if still running)."""
        t1 = self._t1 if self._t1 is not None else time.perf_counter_ns()
        return (t1 - self._t0) / 1e9
