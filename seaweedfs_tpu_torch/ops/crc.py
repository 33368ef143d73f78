"""CRC32C (Castagnoli) — needle data checksum.

The reference checksums every needle's payload with Go's hardware CRC32C
(weed/storage/needle/crc.go:7-21).  Computed by the host C++ library
(csrc/host/crc32c.cpp, SSE4.2), built at first use; a failed build raises
rather than dropping to a byte-at-a-time loop, which is far too slow for a
real volume.
"""
from __future__ import annotations

import numpy as np

from . import _build


def crc32c(data: bytes | bytearray | memoryview | np.ndarray, crc: int = 0) -> int:
    """CRC32C of `data`; chain by passing the previous value as `crc`."""
    # zero-copy view for any buffer-protocol input
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    return int(_build.host().swfs_crc32c(crc, buf.ctypes.data, buf.nbytes))
