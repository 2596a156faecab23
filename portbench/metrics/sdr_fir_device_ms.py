"""Device ms a call of the ops whose innermost program span is
``stream.polyphase.decimate`` (the front end's and the audio decimator's
strided convolutions and their slices; their framing is
``stream.ols.frame``'s) or ``stream.channelizer.branch_fir`` (the grouped
branch FIR and the ``complex`` after it), in the host-ops window
(``portbench/spans.py``). ``None`` where the program has neither span."""

from portbench import spans

SPANS = ("stream.polyphase.decimate", "stream.channelizer.branch_fir")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
