"""Device ms a call of the SDR chain's layout copies: the ops whose
innermost program span is the framing (``stream.ols.frame``), the
channelizer's commutator and its own body (the 1/C scale, the
transposes), or the chain's entry and its two halves (the I/Q ``stack``
and ``complex`` of the front end), in the host-ops window
(``portbench/spans.py``). ``None`` where the program has none of the
chain's spans."""

from portbench import spans

SPANS = ("stream.ols.frame", "stream.channelizer.commutate", "stream.channelizer.forward", "models.sdr.front_end",
         "models.sdr.back_end", "models.sdr.forward")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name.startswith("models.sdr.") for s in w.spans):
        return None
    return w.device_ms(SPANS)
