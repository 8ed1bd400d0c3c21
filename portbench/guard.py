"""Runs that cannot be measured, and the readings that find them.

A result line stands for the program on the card. A run that puts no
work on the card, whose traced window reads no device time or a busy
time outside the window, or whose window completes no query, is not a
measurement of that: it ends with one of these failures, and run.py
prints no result and exits with EXIT_CODE.

The reading of device work is the CUDA caching allocator's cumulative
count of allocations on the run's card: every device path of the
program (torch ops, and the kernel library's launches, whose outputs
torch allocates) moves it, a query that the program runs on the host
leaves it unchanged, and it costs nothing a query. It is read before
and after the warm-up query and before and after the window, never
inside it. Off the card there is no reading and no guard.
"""

from __future__ import annotations

EXIT_CODE = 5


class Unmeasurable(Exception):
    """A run whose numbers would not stand for the program on the card:
    `stage` says where it was found."""

    def __init__(self, stage: str, cause: str):
        super().__init__(cause)
        self.stage = stage


class NoDeviceWork(Unmeasurable):
    """The program put no work on the card in `stage`: the warm-up
    query, the window, or the window's device trace."""

    CAUSES = {
        "warm-up": "the program put no work on the card during the "
                   "warm-up query",
        "window": "the program put no work on the card during the "
                  "measured window",
        "trace": "the device trace of the measured window holds no "
                 "operation",
    }

    def __init__(self, stage: str, cause: str | None = None):
        super().__init__(stage, cause or self.CAUSES[stage])


class EmptyWindow(Unmeasurable):
    def __init__(self):
        super().__init__("window", "no query completed in the measured "
                                   "window")


def work_count(device) -> int | None:
    """The caching allocator's count of allocations so far on `device`;
    None off the card."""
    if device.type != "cuda":
        return None
    import torch
    return int(torch.cuda.memory_stats(device).get(
        "allocation.all.allocated", 0))


def require_work(before: int | None, after: int | None, stage: str):
    """Raise NoDeviceWork(stage) where the reading did not move; readings
    of None (off the card) pass."""
    if before is not None and after <= before:
        raise NoDeviceWork(stage)


def traced(reading: dict | None) -> dict:
    """The window's device reading (trace.device_reading), held to
    0 < busy_s <= window_s."""
    if reading is None:
        raise NoDeviceWork("trace")
    busy, window = reading["busy_s"], reading["window_s"]
    if not 0 < busy <= window:
        raise NoDeviceWork(
            "trace", f"the device trace reads {busy!r} s busy in a window "
                     f"of {window!r} s, outside 0 < busy_s <= window_s")
    return reading


def ended(failure: Unmeasurable, log) -> int:
    """One line on `log` that names the cause; the exit code."""
    log.write(f"no result: {failure} (stage: {failure.stage}); exit code "
              f"{EXIT_CODE}\n")
    log.flush()
    return EXIT_CODE
