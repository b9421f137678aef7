"""engine.decode_host_share.<variant>: the share (%) of the traced decode
steps in which the host was still preparing and enqueueing the step, not
waiting on the device: 100 x the sum over steps of (the step - its
readback) over the sum of the steps. A step is the program's own span
``repro_torch.engine.decode`` around ``Engine.decode_step``, its readback
the ``repro_torch.engine.decode.readback`` spans inside it (the argmax,
its copy to the host and the closing synchronise), both on the profiler's
host timeline; only spans that end inside the traced window count.
``itl`` and ``tput`` read alike, in the cells that report each end-to-end
metric. Nothing is read where the trace holds no decode span (a program
without the spans)."""

DECODE = "repro_torch.engine.decode"
READBACK = "repro_torch.engine.decode.readback"


def spans(td, name):
    """The host events named ``name`` that end inside the traced window."""
    return [s for s in td.host_ops
            if s[0] == name and td.t0_us <= s[2] <= td.t1_us]


def read(run, variant):
    td = run.td
    if td is None:
        return None
    steps = spans(td, DECODE)
    total = sum(b - a for _, a, b in steps)
    if not total:
        return None
    backs = spans(td, READBACK)
    wait = sum(e - s for _, a, b in steps
               for _, s, e in backs if a <= s and e <= b)
    return 100.0 * (total - wait) / total
