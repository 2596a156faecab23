"""Host ms of a call's outermost record of the port's spans (the entry:
``models.convolver.apply``, ``stream.ols.fir_filter_ols``,
``models.sdr.forward``), the median over the device-only window's calls
(``portbench/records.py``): no host op is profiled there. ``.convolve``
and ``.fft`` read alike."""

from portbench import records


def read(r):
    w = records.window(r)
    return None if w is None else w.host_ms()
