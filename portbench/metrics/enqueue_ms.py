"""Host ms from entering the cell's entry to its return, on calls made
just after a synchronise (so that a full launch queue cannot block the
call): the median over those calls."""

import statistics


def read(r):
    if not r.enqueue_s:
        return None
    return 1e3 * statistics.median(r.enqueue_s)
