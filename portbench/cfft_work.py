"""The work of one call of the complex round trip (BASELINE config 2's
complex transform, as upstream's ``bench_complex`` runs it: a forward
then a backward FFT of every row), for its roofline
(``roofline.least_seconds``): what the call must do, whatever kernels
do it. Frozen here so that a change to the program cannot move it.

Bytes: each complex64 row (8 N bytes) read and written once each way,
4 x 8 N a row. Operations: 5 N log2 N a complex FFT, two a row. At
N = 2^20 and 64 rows: 2,147,483,648 bytes and 13,421,772,800
operations, a least time of 0.6410 ms, set by the bytes (the
operations alone take 0.2003 ms).
"""

from __future__ import annotations

import math


def roundtrip_work(n: int, rows: int) -> tuple[float, float]:
    """(bytes, operations) of a forward and a backward complex FFT of
    ``rows`` complex64 rows of ``n``."""
    return float(rows * 4 * 8 * n), float(rows * 2 * 5 * n * math.log2(n))
