"""Device time of a call on the card, by CUDA events: the timer of
``chip_smoke.py`` and of the experiment drivers (``experiments``)."""

import time

import torch

# clock cycles a second of torch.cuda._sleep: at least the SM clock (the
# H100 SXM boosts to 1.98 GHz), so a spin lasts at least as long as asked
SPIN_CYCLES_PER_S = 2e9


def device_ms(fn, reps=20):
    """Mean device milliseconds of *fn* over *reps* calls on the current
    device: the first reading of :func:`timings`."""
    return timings(fn, reps)[0]


def timings(fn, reps=20):
    """(device ms, loop ms): two mean times of *fn* over *reps* calls, by
    CUDA events on the current device.  *fn* runs 2 + 2 * *reps* times
    whatever the readings: two host-timed warm-up calls, then each loop.

    loop ms times a plain loop of calls between two events.  A kernel of
    a few tens of microseconds runs faster than the host launches it, so
    for one this is the host's launch rate.  device ms times the same
    loop queued behind a spin kernel (``torch.cuda._sleep``) that outlasts
    the host's enqueueing, so the events time the device's work back to
    back.  A *fn* that costs the host a millisecond or more, or waits for
    the device (a host sync inside, whose enqueueing outlasts the spin),
    cannot be queued ahead: its device ms is its loop ms."""
    host_s = min(_host_seconds(fn) for _ in range(2))
    spin_s = 2 * reps * host_s + 1e-3 if host_s < 1e-3 else 0.0
    spun_ms, enqueued_s = _events_ms(fn, reps, spin_s)
    loop_ms = _events_ms(fn, reps, 0.0)[0]
    return (spun_ms if enqueued_s < 0.5 * spin_s else loop_ms), loop_ms


def _host_seconds(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def _events_ms(fn, reps, spin_s):
    """(mean event milliseconds of *reps* calls of *fn* queued behind a
    spin of *spin_s* seconds, seconds the host took to enqueue them)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin_s:
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueued_s = time.perf_counter() - t
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, enqueued_s
