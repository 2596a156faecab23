"""Device ms a call of the ops launched inside the port's
``stream.ols.frame`` and ``stream.ols.trim`` spans (the overlap-save
framing of the input and the trim of the output), in the host-ops window
(``portbench/spans.py``)."""

from portbench import spans


def read(r):
    w = spans.host_window(r)
    return None if w is None else w.device_ms(("stream.ols.frame", "stream.ols.trim"))
