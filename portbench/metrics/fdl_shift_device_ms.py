"""Device ms a call of the ops launched inside the port's
``stream.ols.fdl_shift`` spans (the frequency-domain delay line's shift:
the pad of both spectrum planes for each partition after the first), in
the host-ops window (``portbench/spans.py``)."""

from portbench import spans


def read(r):
    w = spans.host_window(r)
    return None if w is None else w.device_ms(("stream.ols.fdl_shift",))
