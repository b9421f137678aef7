"""model.ssm_share.<variant>: the Mamba-1 mixers' share (%) of the traced
prefill steps' device time. A prefill runs on one stream and ends in a
synchronise, so each launch call inside one of the program's
``repro_torch.engine.prefill`` spans (the names of
``engine.decode_launches``' ``LAUNCHES``, a version suffix dropped) starts
one device activity (kernel, copy or set), in the same order. The
profiler's device clock runs up to a few hundred microseconds off its host
clock, so the activities are not taken by the span's bounds: they are
paired from the prefill's end, its last launch (the first token's copy to
the host, the prefill's one such copy) with the first ``Memcpy DtoH``
that starts after it (and within ``SKEW_US`` of the span's end), and so on
back. The first launch, the prompt's
upload from pageable memory, is left out on both sides: the profiler
records that copy only at times. 100 x the device time of the activities
whose launch lies inside a ``repro_torch.model.ssm`` span (a Mamba-1
layer's norm through its residual add), over the device time of all the
paired activities. A prefill with a pair of different kinds (kernel,
copy, set) is skipped; nothing is read where no prefill paired (a
program without the spans, or a trace without a whole prefill). ``tput``
in the jamba cell."""
import bisect
import importlib.util
from pathlib import Path

PREFILL = "repro_torch.engine.prefill"
SSM = "repro_torch.model.ssm"
SKEW_US = 1000.0


def _is_launch():
    path = Path(__file__).with_name("engine.decode_launches.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_engine_decode_launches", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.is_launch


def _kind(name: str) -> str:
    """A launch call's or a device activity's kind: copy, set or
    kernel."""
    n = name.lower()
    return next((k for k in ("memcpy", "memset") if k in n), "kernel")


def prefills(td):
    """For each prefill span wholly in the traced window: its launches
    after the first as (start, name), and as many device activities as
    (start, duration, name), paired in order from the prefill's closing
    copy back; or None where that copy is not found or a pair's kinds
    differ."""
    is_launch = _is_launch()
    launches = sorted((a, name) for name, a, _ in td.host_ops
                      if is_launch(name))
    device = sorted((a, b - a, name) for name, a, b in td.device)
    starts = [d[0] for d in device]
    out = []
    for name, a, b in td.host_ops:
        if name != PREFILL or a < td.t0_us or b > td.t1_us:
            continue
        ls = launches[bisect.bisect_left(launches, (a,)):
                      bisect.bisect_right(launches, (b, "~"))][1:]
        if not ls:
            out.append(None)
            continue
        # the closing copy: the first to the host after the last launch
        end = bisect.bisect_left(starts, ls[-1][0])
        while end < len(device) and not device[end][2].startswith(
                "Memcpy DtoH"):
            end += 1
        ds = device[max(0, end + 1 - len(ls)):end + 1]
        ok = (end < len(device) and device[end][0] <= b + SKEW_US
              and len(ds) == len(ls)
              and all(_kind(ln) == _kind(dn)
                      for (_, ln), (_, _, dn) in zip(ls, ds)))
        out.append((ls, ds) if ok else None)
    return out


def read(run, variant):
    td = run.td
    if td is None:
        return None
    spans = sorted((a, b) for name, a, b in td.host_ops if name == SSM)
    span_starts = [a for a, _ in spans]
    total = part = 0.0
    for paired in prefills(td):
        if paired is None:
            continue
        for (t, _), (_, dur, _) in zip(*paired):
            total += dur
            i = bisect.bisect_right(span_starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                part += dur
    if not total:
        return None
    return 100.0 * part / total
