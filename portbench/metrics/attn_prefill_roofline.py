"""attn_prefill_roofline.<variant>: whole-prompt causal attention's share
(%) of its roofline in the traced window: the sum over its calls of the
bound (``pbench.counts``: the larger of FLOPs / 989 TFLOP/s and bytes /
3.35 TB/s, from each call's prompt length and heads) over the sum of the
profiler's device time of the kernels that compute it today. The count
follows the operation: one call per attention layer (the architecture's
``attn_layers``) per prefill step. Nothing is read unless the traced
window holds exactly that many calls."""
from pbench import counts

KERNELS = ("flash_fwd_kernel",)


def read(run, variant):
    if run.td is None:
        return None
    steps = run.steps_in(run.prefills, run.t0, run.t1)
    L = run.arch.attn_layers(run.p)
    calls = run.td.kernels(*KERNELS)
    if not steps or len(calls) != L * len(steps):
        return None
    bound = sum(L * counts.bound_s(counts.attn_prefill_flops(run.p, S),
                                   counts.attn_prefill_bytes(run.p, S))
                for _, _, S, _ in steps)
    device = sum(b - a for _, a, b in calls) / 1e6
    return 100.0 * bound / device
