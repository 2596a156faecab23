"""Host self ms a call of the real composite's drivers: the records of
``ops.hopper_composite.rfft_composite`` and ``.irfft_composite`` less the
launch records inside them, in the device-only window
(``portbench/records.py``)."""

from portbench import records

DRIVERS = ("ops.hopper_composite.rfft_composite", "ops.hopper_composite.irfft_composite")


def read(r):
    w = records.window(r)
    return None if w is None else w.self_ms(DRIVERS)
