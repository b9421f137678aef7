"""engine.decode_step_ms.<variant>: the mean measured time of the
in-window decode steps (the engine's host clock, ending in a device
synchronise), in ms."""


def read(run, variant):
    steps = run.window_decodes()
    if not steps:
        return None
    return 1e3 * sum(s[1] for s in steps) / len(steps)
