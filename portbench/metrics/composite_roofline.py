"""The composite's column kernels' share of their roofline: the least
time of their work (``longir_work.composite_work``: two passes of 8 N
bytes and 2.5 N log2 N operations on every row) over the device ms a
call of the ops in their launch spans (``composite_kernel_device_ms``
without K4's), in the host-ops window (``portbench/spans.py``)."""

from portbench import roofline, spans
from portbench.metrics.composite_kernel_device_ms import COLUMNS


def read(r):
    work = r.work.get("composite")
    w = spans.host_window(r)
    if work is None or w is None or not any(s.name in COLUMNS for s in w.spans):
        return None
    ms = w.device_ms(COLUMNS)
    if not ms:
        return None
    return 100.0 * roofline.least_seconds(*work) / (ms / 1e3)
