"""The long-IR reverb's share of its roofline: the least time of one
call's work (``longir_work.call_work``: x, the IRs and y once; the FFTs
of every IR and frame row and the packed products) over the device's
busy time a call (the union of its op intervals over the calls)."""

from portbench import roofline


def read(r):
    work = r.work.get("longir")
    if work is None or r.busy_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(*work) / (r.busy_s / r.calls)
