"""Host ms a call inside the port's ``api.*`` spans and outside its
``ops._cuda.launch.*`` spans (the Python dispatch around the launches),
the median over the calls of the host-ops window
(``portbench/spans.py``): profiled host time, which reads high."""

from portbench import spans


def read(r):
    w = spans.host_window(r)
    return None if w is None else w.host_ms(spans.API, outside=spans.LAUNCH)
