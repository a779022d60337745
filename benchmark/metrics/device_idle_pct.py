"""Device: the share of the profiled stretch in which no kernel, copy or
set ran on the card (the device's own events in the profiler's trace)."""
SPANS = ()


def read(t):
    d = t.device
    if d is None or d.window_s <= 0 or d.n_device_events == 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
