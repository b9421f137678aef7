"""cluster.host_share.<variant>: the share (%) of the window's wall time
outside every engine's timed steps: the event loop's own work (admission,
routing, the handoff, per-token bookkeeping) and its idle waits."""


def read(run, variant):
    steps = run.window_prefills() + run.window_decodes()
    if not steps:
        return None
    busy = sum(s[1] for s in steps)
    return 100.0 * max(0.0, 1.0 - busy / (run.w1 - run.w0))
