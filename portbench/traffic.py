"""The one traffic generator: it reads a mix's parameters from
``portbench/traffic/<mix>.json`` and draws, from the run's seed, what the
mix leaves open.

A mix's keys:

- ``entry``: which entry of the configuration's system the calls drive
  (``apply``, ``roundtrip``, ...), back to back with no synchronise
  between them;
- the shapes the entry reads (``clip_seconds``, ``batch``, ...), every
  seed the same;
- ``ring``: how many seeded input buffers the calls cycle through (so the
  inputs exceed the card's 50 MB L2 where the mix says so);
- ``warmup_calls``, ``trace_calls``, ``enqueue_calls``: the calls of the
  warm-up, of a traced run's profiled window and of its enqueue probe;
- ``kept``: how many calls' outputs are kept, drawn from the seed, for
  the comparison after the window.
"""

from __future__ import annotations

import random

REQUIRED = ("entry", "warmup_calls", "trace_calls", "enqueue_calls", "kept")


class Plan:
    """What one run's calls take, drawn from ``seed``: the ring slot of
    each call (the same slots every seed, in another order) and the
    sample of calls whose outputs are compared."""

    def __init__(self, mix: dict, seed: int):
        missing = [k for k in REQUIRED if k not in mix]
        if missing:
            raise ValueError(f"traffic mix lacks {missing}")
        self.mix = mix
        self.ring = int(mix.get("ring", 1))
        rng = random.Random(seed)
        self.order = list(range(self.ring))
        rng.shuffle(self.order)
        self._rng = random.Random(rng.getrandbits(64))
        self.kept: dict[int, object] = {}
        self._offered = 0

    def __getitem__(self, key):
        return self.mix[key]

    def slot(self, call: int) -> int:
        """The ring buffer that call ``call`` reads."""
        return self.order[call % self.ring]

    def offer(self, call: int, out) -> None:
        """Reservoir sampling: after n offers every one of them is kept
        with the same chance, ``kept`` of them at most."""
        k = int(self.mix["kept"])
        self._offered += 1
        if len(self.kept) < k:
            self.kept[call] = out
            return
        j = self._rng.randrange(self._offered)
        if j < k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[call] = out
