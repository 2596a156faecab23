"""Device idle ms a call whose gap's middle falls inside one of the
port's spans: the idle gaps between the device's busy intervals in the
host-ops window (``portbench/spans.py``), summed over the window and
divided by its calls."""

from portbench import spans


def read(r):
    w = spans.host_window(r)
    return None if w is None else w.idle_ms()
