"""One run of one cell: set-up, the measured window, the check.

The window drives ``repro_torch.serving.cluster.Cluster.serve`` over the
port's ``Engine``s, built through their public constructors as the
port's launcher builds them, with the pools, scheduler and router that
the cell's file names (``FCFSScheduler``, ``RoundRobinRouter``, no rate
matcher, for the cells of this benchmark). The weights are the
benchmark's (``weights.draw``, laid out by the configuration's
architecture, ``archs/<arch>.py``), the traffic its generator's, paced on
the wall clock (``pacing``).

Set-up is everything from the process's start to the window's opening:
CUDA's start, the kernels' libraries (built on a checkout's first run
into the port's build directory inside the checkout), the weights, the
engines, one prefill at each pool engine at the mix's longest and
shortest prompt, and the ramp: the load runs for the mix's ``ramp_s``
before the window opens, so that the batch is in its steady state.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Any, Dict, List

import numpy as np

from pbench import check, spec, trace, traffic as traffic_mod
from pbench.pacing import (PacedWorkload, WallRecorder, WindowClosed,
                           capture)
from pbench.weights import draw, param_bytes


class RunData:
    """What the per-layer readers read: the port keys ``p`` and the
    architecture's module ``arch`` (``archs/<arch>.py``), the window
    [w0, w1] (wall seconds), the requests' stamps, the steps (see
    ``WallRecorder``), and for a traced run the trace (``td``) and its
    wall window [t0, t1] with the steps inside it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def steps_in(self, steps, lo, hi):
        return [s for s in steps if lo < s[0] <= hi]

    def window_prefills(self):
        return self.steps_in(self.prefills, self.w0, self.w1)

    def window_decodes(self):
        return self.steps_in(self.decodes, self.w0, self.w1)


def model_config(p: Dict[str, Any]):
    from repro_torch.models.config import ModelConfig, MoEConfig
    kw = dict(p)
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


def capacity_for(mix: Dict[str, Any], block_size: int) -> int:
    """Room for the mix's longest prompt and output, in whole blocks, and
    one block more."""
    n = traffic_mod.bounds(mix["isl"])[1] + traffic_mod.bounds(mix["osl"])[1]
    return -(-n // block_size) * block_size + block_size


def build_cluster(cfg, params, deploy: Dict[str, Any], capacity: int,
                  recorder, device):
    from repro_torch.serving import policies
    from repro_torch.serving.backends import make_engine
    from repro_torch.serving.cluster import Cluster
    pools = {}
    eid = 0
    for role, pool in deploy["pools"].items():
        engines = []
        for _ in range(pool["engines"]):
            engines.append(make_engine(
                "torch", eid, cfg, params, slots=pool["slots"],
                capacity=capacity, block_size=deploy["block_size"],
                device=device))
            eid += 1
        pools[role] = engines
    return Cluster(pools,
                   scheduler=getattr(policies,
                                     deploy["scheduler"]["class"])(),
                   router=getattr(policies, deploy["router"]["class"])(),
                   rate_matcher=None, sanitize=False, recorder=recorder)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Bench:
    """A cell set up: its files read, the weights drawn, the cluster built
    and warmed up. ``serve`` runs the load for a ramp and a window (and,
    traced, the traced window after it); ``check`` frees the program's
    state and decides ``correct``."""

    def __init__(self, cell_name: str, seed: int, *, t_start: float,
                 device=None, root=spec.ROOT, traced: bool = False,
                 log=lambda s: print(s, file=sys.stderr)):
        import torch
        self.log = log
        self.seed = seed
        self.t_start = t_start
        b = spec.load(root / "BENCHMARK.json")
        entry = spec.cell_entry(b, cell_name)
        config = spec.read_json(root / spec.config_entry(
            b, entry["config"])["file"])
        self.p = config["port"]
        self.arch = spec.config_arch(config, root)
        self.mix = traffic_mod.load(spec.traffic_file(entry["traffic"],
                                                      root))
        self.deploy = spec.read_json(spec.cell_file(cell_name, root))
        self.device = torch.device(device or "cuda")
        self.traced = traced
        cfg = model_config(self.p)
        self.params = draw(self.p, seed, self.device,
                           self.arch.layout(self.p))
        _sync(self.device)
        log(f"# weights: {param_bytes(self.params) / 1e9:.3f} GB, "
            f"{time.perf_counter() - t_start:.2f} s since start")
        self.capacity = capacity_for(self.mix, self.deploy["block_size"])
        self.recorder = WallRecorder({}, self._tick)
        self.cluster = build_cluster(cfg, self.params, self.deploy,
                                     self.capacity, self.recorder,
                                     self.device)
        engines = self.cluster.engines()
        log(f"# engines built: {time.perf_counter() - t_start:.2f} s since "
            "start")
        # one prefill per pool engine at the longest and shortest prompt
        for eng in self.cluster.prefill_capable():
            for n in reversed(traffic_mod.bounds(self.mix["isl"])):
                eng.prefill(np.zeros(n, np.int32))
        _sync(self.device)
        if traced:
            for eng in engines:
                eng.prefill = trace.spanned("portbench.prefill", eng.prefill)
                eng.decode_step = trace.spanned("portbench.decode",
                                                eng.decode_step)
            with trace.profiler():      # the profiler's own first start
                torch.ones(1, device=self.device).add_(1)
                _sync(self.device)
        log(f"# engines: {len(engines)}, capacity {self.capacity}, "
            f"{time.perf_counter() - t_start:.2f} s since start")
        self._stop = self._w1 = float("inf")
        self._prof = None

    def _tick(self, now: float) -> None:
        if self.traced and self._prof is None and now >= self._w1:
            self._prof = trace.profiler()
            self._prof.start()
            self._t_prof = time.perf_counter()
        if now >= self._stop:
            raise WindowClosed

    def serve(self, mix: Dict[str, Any], seconds: float) -> RunData:
        """Ramp for ``mix["ramp_s"]``, then measure for ``seconds`` (and,
        traced, ``trace.TRACE_SECONDS`` more under the profiler)."""
        from repro_torch.serving.request import Request
        stop_s = float(mix["ramp_s"]) + seconds + (
            trace.TRACE_SECONDS if self.traced else 0.0)
        stream = traffic_mod.Traffic(mix, self.seed, self.p["vocab_size"],
                                     horizon_s=stop_s)
        prebuilt = min(stream.n, 4096)
        rec = self.recorder
        rec.prefills, rec.decodes = [], []
        rec.requeued = rec.failures = rec.handoff_bytes = 0
        self._prof = None
        cluster = self.cluster

        def make_request(j, prompt, osl, arrival_t):
            return Request(rid=j, prompt=prompt, osl=osl,
                           arrival_t=arrival_t)

        t_load = time.perf_counter()
        w0 = t_load + float(mix["ramp_s"])
        self._w1 = w1 = w0 + seconds
        self._stop = w1 + (trace.TRACE_SECONDS if self.traced else 0.0)
        work = PacedWorkload(stream, t0=t_load, stop_at=self._stop,
                             make_request=make_request,
                             cluster_now=lambda: cluster.now,
                             prebuilt=prebuilt)
        rec.stamps = work.stamps
        from repro_torch.models import transformer
        rec.box, rec.served_logit = {}, {}
        undo = capture(transformer, rec.box)
        try:
            cluster.serve(work)
        except WindowClosed:
            pass
        finally:
            undo()
        t_end = time.perf_counter()
        td = t_prof = None
        if self._prof is not None:
            self._prof.stop()
            t_prof = self._t_prof
            td = trace.read(self._prof, t_end - t_prof)
            self._prof = None
            self.log(f"# trace: {len(td.device)} device and "
                     f"{len(td.host_ops)} host events, read in "
                     f"{time.perf_counter() - t_end:.2f} s")
        _sync(self.device)
        stamps = list(work.stamps.values())
        return RunData(p=self.p, arch=self.arch, w0=w0, w1=w1,
                       stamps=stamps, prefills=rec.prefills,
                       decodes=rec.decodes, td=td,
                       t0=t_prof, t1=t_end if td is not None else None,
                       setup_s=w0 - self.t_start,
                       handoff_bytes=rec.handoff_bytes,
                       attempted=sum(1 for s in stamps if w0 <= s.due < w1),
                       failed=rec.requeued + rec.failures,
                       backlog=sum(1 for s in stamps
                                   if s.prefill_start is None),
                       released=work.released,
                       served_logit=rec.served_logit)

    def check(self, run: RunData, *, control: bool = False
              ) -> Dict[str, Any]:
        """Free the program's state, then compare a sample of the finished
        requests with the reference (and, with ``control``, read the
        control's numbers on the same sample)."""
        import torch
        done = [s.req for s in run.stamps if s.done is not None]
        served_logit = run.served_logit
        self.cluster = self.recorder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        chk = self.deploy["check"]
        sample = check.pick_sample(done, self.seed, chk["served_tokens"],
                                   chk["max_requests"])
        served = sum(len(r.output) for r in sample)
        values = {k: float("inf") for k in check.NUMBERS}
        out: Dict[str, Any] = {}
        t_ref = time.perf_counter()
        if sample:
            from pbench.reference import fp8_quant
            Reference = self.arch.Reference
            seqs, n_last, toks = check.sequences(sample, self.device)
            ref = Reference(self.p, self.params).logits(seqs, n_last)
            logits = check.served_logits(sample, served_logit, self.device)
            values = check.numbers(ref, toks, logits)
            if control:
                low = Reference(self.p, self.params,
                                quant=fp8_quant).logits(seqs, n_last)
                firsts = [lg.argmax(dim=-1) for lg in low]
                tops = [lg.max(dim=-1).values for lg in low]
                out["control"] = check.numbers(ref, firsts, tops)
                del low
            del ref
        correct, rows = check.decide(values, chk["limits"], served,
                                     chk["min_served_tokens"])
        self.log(f"# check: {len(sample)} of {len(done)} finished "
                 f"requests, {served} served tokens, reference "
                 f"{time.perf_counter() - t_ref:.2f} s")
        out.update(correct=correct, checks=rows, values=values,
                   served=served, sampled=len(sample))
        return out


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device=None, root=spec.ROOT,
        log=lambda s: print(s, file=sys.stderr)) -> Dict[str, Any]:
    """Serve cell ``cell_name`` once: the result's fields (without the
    device's name) and, under ``"_run"``, the ``RunData``."""
    import torch
    bench = Bench(cell_name, seed, t_start=t_start, device=device,
                  root=root, traced=traced, log=log)
    run_data = bench.serve(bench.mix, seconds)
    memory_peak = (torch.cuda.max_memory_allocated(bench.device)
                   if bench.device.type == "cuda" else 0)
    out = bench.check(run_data)
    return {"correct": out["correct"], "attempted": run_data.attempted,
            "failed": run_data.failed, "memory_peak_bytes": int(memory_peak),
            "checks": out["checks"], "_run": run_data}


def finite(x: float) -> float:
    """A number JSON can carry: a non-finite reading as 1e30."""
    return x if math.isfinite(x) else 1e30


__all__: List[str] = ["run", "RunData", "model_config", "capacity_for",
                      "build_cluster", "finite"]
