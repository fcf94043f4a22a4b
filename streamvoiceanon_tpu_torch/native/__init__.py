"""ctypes bindings for the audio transport's wait-free SPSC ring
(`csrc/ringbuffer.cpp`), as the JAX package's `native/__init__.py`.

The library is built with the host compiler on first use
(`ops/_build.py` `load_host`); a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from streamvoiceanon_tpu_torch.ops import _build


def _ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """Wait-free single-producer single-consumer float ring.  Its capacity
    is `min_capacity` rounded up to a power of two.  A write into a full
    ring overwrites the oldest samples (counted in `overruns`); a read of
    more than is available pads with zeros (counted in `underruns`)."""

    def __init__(self, min_capacity: int):
        self._lib = _build.load_host("ringbuffer")
        self._h = self._lib.svan_ring_create(min_capacity)
        if not self._h:
            raise MemoryError("svan_ring_create failed")

    def write(self, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, np.float32)
        return int(self._lib.svan_ring_write(self._h, _ptr(x), len(x)))

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        self._lib.svan_ring_read(self._h, _ptr(out), n)
        return out

    def capacity(self) -> int:
        return int(self._lib.svan_ring_capacity(self._h))

    def available(self) -> int:
        return int(self._lib.svan_ring_available(self._h))

    def overruns(self) -> int:
        return int(self._lib.svan_ring_overruns(self._h))

    def underruns(self) -> int:
        return int(self._lib.svan_ring_underruns(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.svan_ring_destroy(self._h)
            self._h = None
