"""Device ms a call of the ops launched inside the port's
``ops.convolve.accumulate_partitioned`` span and the launch span of its
kernel (the offline FDL: every partition's packed product summed in one
pass), in the host-ops window (``portbench/spans.py``). ``None`` where the
program has neither span."""

from portbench import spans

SPANS = ("ops.convolve.accumulate_partitioned", "ops._cuda.launch.partitioned_accumulate_kernel")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
