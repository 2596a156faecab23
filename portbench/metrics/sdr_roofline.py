"""The SDR chain's share of its roofline: the least time of one call's
work (``sdr_work.chain_work``: the capture read and the audio written
once, the operations of its five stages) over the device's busy time a
call (the union of its op intervals over the calls)."""

from portbench import roofline


def read(r):
    work = r.work.get("sdr")
    if work is None or r.busy_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(*work) / (r.busy_s / r.calls)
