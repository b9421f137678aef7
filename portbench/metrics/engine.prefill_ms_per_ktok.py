"""engine.prefill_ms_per_ktok.<variant>: the in-window prefill steps'
measured time (the engine's host clock, ending in a device synchronise)
over their prompt tokens, in ms per 1,000 tokens."""


def read(run, variant):
    steps = run.window_prefills()
    tokens = sum(s[2] for s in steps)
    if not tokens:
        return None
    return 1e6 * sum(s[1] for s in steps) / tokens
