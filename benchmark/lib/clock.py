"""Set-up's phases on the host clock, written to standard error."""

from __future__ import annotations

import sys
import time


def log_stamps():
    """A function that writes the seconds since its last call (or since
    this one) to standard error, under a label."""
    last = [time.perf_counter()]

    def stamp(what: str) -> None:
        now = time.perf_counter()
        print(f"[bench] {what}: {now - last[0]:.3f} s", file=sys.stderr,
              flush=True)
        last[0] = now
    return stamp
