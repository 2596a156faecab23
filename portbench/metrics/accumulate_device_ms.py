"""Device ms a call of the ops launched inside the port's
``ops.convolve.accumulate_packed`` spans (the packed convolve-accumulate
of each partition), in the host-ops window (``portbench/spans.py``)."""

from portbench import spans


def read(r):
    w = spans.host_window(r)
    return None if w is None else w.device_ms(("ops.convolve.accumulate_packed",))
