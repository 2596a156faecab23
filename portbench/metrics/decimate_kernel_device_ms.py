"""Device ms a call of the ops launched inside the launch span of the
port's polyphase decimator (``ops._cuda.launch.polyphase_decimate_kernel``:
the SDR chain's front end and audio filter, each one pass over the
unframed stream), in the host-ops window (``portbench/spans.py``).
``None`` where the program has no such span."""

from portbench import spans

SPANS = ("ops._cuda.launch.polyphase_decimate_kernel",)


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
