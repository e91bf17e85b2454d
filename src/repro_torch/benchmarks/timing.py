"""Device timing of a function on the card, by two readings: the GPU
activity ``torch.profiler`` records, and CUDA events over back-to-back
calls queued behind a spin kernel. ``chip_smoke.py`` and
``bench_kernels`` read every kernel with :func:`kernel_ms`; each reading is
kept in :data:`READINGS` under its label.

Needs the card: the functions raise without one.
"""
from __future__ import annotations

import time

import torch

# the spin kernel's clock (H100 SXM boost, 1.98 GHz) when it is asked to
# outlast a span: a slower clock only lengthens the spin
SPIN_CYCLES_PER_S = 2.0e9
# profiles of one timing, at most, until the device operations come out a
# whole number a call
PROFILE_ATTEMPTS = 5
# events_ms repeats its trial of back-to-back calls only while one lasts
# less than this (seconds); a longer one is read once
TRIAL_REPEAT_S = 0.1

# label -> both device-time readings of a function timed by kernel_ms
READINGS = {}


def time_ms(fn, reps=50, warmup=5):
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after a warm-up: the call's throughput, host overhead
    included when it exceeds the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(prof):
    """Total duration of the GPU activities (kernels, memsets, copies) a
    torch.profiler run recorded, in microseconds."""
    from torch.autograd import DeviceType
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def device_ops(prof):
    """The number of GPU activities (kernels, memsets, copies) a
    torch.profiler run recorded."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def events_ms(fn, reps=20, warmup=3, trials=3):
    """Device ms per call of ``fn`` by CUDA events: ``reps`` back-to-back
    calls queued behind a spin kernel that outlasts the host's enqueue of
    them, so the events time the device's work and the gaps between its
    launches, not the host. A disturbance (the host preempted past the
    spin, another process on the card) only lengthens a trial, so the
    trial is taken up to ``trials`` times, while one lasts under
    TRIAL_REPEAT_S, and the least is kept. Returns (ms, hidden) of that
    trial: ``hidden`` is False when the spin ended before the host had
    queued every call, so the reading may hold host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_s = min(2.0, 2 * enqueue_s + 1e-3)
    best = None
    for _ in range(trials):
        torch.cuda._sleep(int(SPIN_CYCLES_PER_S * spin_s))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not start.query()
        end.synchronize()
        ms = start.elapsed_time(end)
        if best is None or ms < best[0]:
            best = (ms, hidden)
        if ms > TRIAL_REPEAT_S * 1e3:
            break
    return best[0] / reps, best[1]


def kernel_ms(fn, label, reps=20, ops=None):
    """Device time per call of ``fn``, read two ways: the GPU activity
    torch.profiler records over ``reps`` calls, and CUDA events over
    back-to-back calls (:func:`events_ms`). Each call launches the same
    operations, so a profile whose count is not a positive multiple of
    ``reps`` (with ``ops``, the operations a call is known to launch: not
    ``ops * reps``) dropped activities: it is taken again, up to
    PROFILE_ATTEMPTS times.
    Prints both readings and keeps them in READINGS under ``label``, with
    the operations counted (``whole``: from a whole profile, else the
    largest count seen). Returns the profiler's reading of a whole
    profile, else the events'."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n_ops, dev_us, whole = -1, 0.0, False
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        count = device_ops(prof)
        # a profile that recorded nothing dropped everything
        whole = (count == ops * reps if ops is not None
                 else count > 0 and count % reps == 0)
        if whole or count > n_ops:
            n_ops, dev_us = count, device_us(prof)
        if whole:
            break
        print(f"kernel_ms {label}: the profiler recorded {count} device "
              f"operations over {reps} calls (attempt {attempt + 1})",
              flush=True)
    prof_ms = dev_us / 1e3 / reps
    ev_ms, hidden = events_ms(fn, reps)
    READINGS[label] = dict(profiler_ms=prof_ms, events_ms=ev_ms,
                           ops=n_ops, reps=reps, ops_per_call=n_ops / reps,
                           whole=whole, host_hidden=hidden)
    print(f"kernel_ms {label}: profiler {prof_ms:.6g} ms, CUDA events "
          f"{ev_ms:.6g} ms{'' if hidden else ' (host not hidden)'}, "
          f"{n_ops / reps:g} device ops a call", flush=True)
    if not whole or prof_ms <= 0:
        print(f"kernel_ms {label}: "
              + ("no whole profile" if not whole else "no device time")
              + "; using the CUDA events' reading", flush=True)
        return ev_ms
    return prof_ms
