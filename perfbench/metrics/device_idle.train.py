"""% of an unprofiled training step (steps issued back to back) in which
no device operation runs: the device's busy time per step, from the
device window, against a step's time in the plain window, which neither
the profiler nor the stage timer slows. Read within the profiled window
instead, the share would be mostly the profiler's: its device tracing
costs the host 6 to 12 us a launch (PERF.md, section 6)."""


def read(t):
    if not t.launches or not t.step_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.steps / t.step_s)
