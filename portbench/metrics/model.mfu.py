"""model.mfu.<variant>: the whole step's share (%) of the card's bf16 peak:
model FLOPs (the architecture's ``prefill_flops`` and ``decode_flops``,
``archs/<arch>.py``: the projections a token passes through, the top-k
experts only, the head where logits are taken, causal attention) of the
in-window steps over their measured time x 989 TFLOP/s. ``prefill``:
prefill steps; ``decode``: decode steps; ``tput``: both."""
from pbench import counts


def read(run, variant):
    flops = secs = 0.0
    if variant in ("prefill", "tput"):
        for _, dt, S, _ in run.window_prefills():
            flops += run.arch.prefill_flops(run.p, S)
            secs += dt
    if variant in ("decode", "tput"):
        for _, dt, active, ctx, _ in run.window_decodes():
            flops += run.arch.decode_flops(run.p, active, ctx)
            secs += dt
    if not secs:
        return None
    return 100.0 * flops / (secs * counts.PEAK_BF16_FLOPS)
