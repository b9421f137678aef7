"""device.idle_share.<variant>: the share (%) of time with no device
activity (kernel, copy or set) running, from the profiler's trace.
``itl``: within the traced decode steps (the benchmark's
``portbench.decode`` spans around ``Engine.decode_step``); ``tput``:
over the whole traced window."""


def read(run, variant):
    td = run.td
    if td is None or not td.device:
        return None
    if variant == "tput":
        return 100.0 * max(0.0, 1.0 - td.busy_s / td.window_s)
    spans = [s for s in td.spans if s[0] == "portbench.decode"]
    total = sum(b - a for _, a, b in spans)
    if not total:
        return None
    busy = sum(td.busy_us(a, b) for _, a, b in spans)
    return 100.0 * (1.0 - busy / total)
