"""Device idle ms a call in the device-only window, of the gaps between
the device's busy intervals whose middle falls inside one of the port's
own records of its spans, mapped onto the window's clock
(``portbench/records.py``). ``.convolve`` and ``.fft`` read alike."""

from portbench import records


def read(r):
    w = records.window(r)
    return None if w is None else w.idle_ms()
