"""Profiler ranges of the port, entered only while ``torch.profiler`` records.

A range's row in the profiler's ``key_averages`` carries the device time of
every kernel launched inside it, so a range around a layer is that layer's
share of the device trace.  With the profiler off nothing is entered: a
call site pays one read of the profiler's flag.  The flag is read through
its module at every call; a name imported from it would keep its value at
import time.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["NULL_RANGE", "prof_range", "ranged"]

NULL_RANGE = nullcontext()


def prof_range(name: str):
    """``record_function(name)`` while the profiler records, else the shared
    no-op context :data:`NULL_RANGE`."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return NULL_RANGE


def ranged(name: str):
    """Decorator: every call of the function inside ``prof_range(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _profiler._is_profiler_enabled:
                with record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return inner
    return wrap
