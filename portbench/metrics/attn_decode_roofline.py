"""attn_decode_roofline.<variant>: paged decode attention's share (%) of
its roofline in the traced window: the sum over its calls of the bound
(``pbench.counts``, from each step's rows and attended positions: an
active slot attends its prompt and its tokens so far, an idle slot one
row) over the sum of the profiler's device time of the kernels that
compute it today (the split pass and its merge). One call per attention
layer (the architecture's ``attn_layers``) per decode step; nothing is
read unless the traced window holds exactly that many split launches."""
from pbench import counts

SPLIT = "paged_decode_kernel"
KERNELS = (SPLIT, "split_merge_kernel")


def read(run, variant):
    if run.td is None:
        return None
    steps = run.steps_in(run.decodes, run.t0, run.t1)
    L = run.arch.attn_layers(run.p)
    if not steps or len(run.td.kernels(SPLIT)) != L * len(steps):
        return None
    bound = 0.0
    for _, _, active, ctx, slots in steps:
        ctx_all = ctx + (slots - active)
        bound += L * counts.bound_s(
            counts.attn_decode_flops(run.p, ctx_all),
            counts.attn_decode_bytes(run.p, slots, ctx_all))
    device = sum(b - a for _, a, b in run.td.kernels(*KERNELS)) / 1e6
    return 100.0 * bound / device
