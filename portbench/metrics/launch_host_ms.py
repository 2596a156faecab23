"""Host ms a call inside the port's ``ops._cuda.launch.*`` spans (the
ctypes calls that launch its kernels), the median over the calls of the
host-ops window (``portbench/spans.py``): profiled host time, which
reads high."""

from portbench import spans


def read(r):
    w = spans.host_window(r)
    return None if w is None else w.host_ms(spans.LAUNCH)
