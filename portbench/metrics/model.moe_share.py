"""model.moe_share.<variant>: the MoE FFN's share (%) of the traced decode
steps' wall time: 100 x the summed ``repro_torch.model.moe`` spans (each
layer's ``_ffn_aux``: its norm, ``moe_ffn`` and the residual add) inside
the program's ``repro_torch.engine.decode`` spans over the summed decode
spans, on the profiler's host timeline, the spans that end inside the
traced window. While the device idles most of a step, this is the host's
time in the MoE FFN. ``itl`` in the MoE cell. Nothing is read where the
trace holds no decode or no MoE span (a dense model, or a program
without the spans)."""

DECODE = "repro_torch.engine.decode"
MOE = "repro_torch.model.moe"


def read(run, variant):
    td = run.td
    if td is None:
        return None
    inside = [s for s in td.host_ops if s[0] in (DECODE, MOE)
              and td.t0_us <= s[2] <= td.t1_us]
    steps = [s for s in inside if s[0] == DECODE]
    total = sum(b - a for _, a, b in steps)
    moe = sum(e - s for _, a, b in steps
              for name, s, e in inside if name == MOE and a <= s and e <= b)
    if not total or not moe:
        return None
    return 100.0 * moe / total
