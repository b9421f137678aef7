"""The traffic generator: determinism by seed, one multiset per mix for
every seed, the length and gap distributions, wall-clock pacing."""
import numpy as np
import pytest

from pbench import traffic
from pbench.pacing import PacedWorkload

OPEN = {"arrivals": {"process": "poisson", "rate": 5.0},
        "isl": {"dist": "loguniform", "lo": 512, "hi": 1920},
        "osl": {"dist": "loguniform", "lo": 16, "hi": 96}, "ramp_s": 10}
CLOSED = {"arrivals": {"process": "closed", "clients": 8},
          "isl": {"dist": "uniform", "lo": 32, "hi": 128},
          "osl": {"dist": "uniform", "lo": 64, "hi": 64}, "pool": 8,
          "ramp_s": 1}
BIG_SEED = 2 ** 31 + 12345


def items(mix, seed, n, horizon=60.0):
    t = traffic.Traffic(mix, seed, 1000, horizon_s=horizon)
    return t, [t.item(j) for j in range(n)]


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, -3])
def test_same_seed_same_inputs(seed):
    t1, a = items(OPEN, seed, 40)
    t2, b = items(OPEN, seed, 40)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.osl == y.osl
    assert [t1.due(j) for j in range(40)] == [t2.due(j) for j in range(40)]


def test_seeds_permute_one_multiset():
    t1, a = items(OPEN, 1, 300)
    t2, b = items(OPEN, 2, 300)
    assert t1.n == t2.n == 300
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt)
                                                      for x in b)
    assert sorted(x.osl for x in a) == sorted(x.osl for x in b)
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]
    # the gaps sum to the horizon whatever the seed
    assert t1.due(299) == pytest.approx(t2.due(299))
    assert t1.due(299) == pytest.approx(60.0, rel=1e-9)


def test_length_distributions():
    v = traffic.length_pool({"dist": "loguniform", "lo": 512, "hi": 1920},
                            4096)
    assert v.min() >= 512 and v.max() <= 1920
    assert v.mean() == pytest.approx(1408 / np.log(1920 / 512), rel=0.01)
    assert np.median(v) == pytest.approx(np.sqrt(512 * 1920), rel=0.01)
    u = traffic.length_pool({"dist": "uniform", "lo": 32, "hi": 128}, 97)
    assert u.mean() == pytest.approx(80, abs=0.5)
    assert set(traffic.length_pool({"dist": "uniform", "lo": 9, "hi": 9},
                                   5)) == {9}


def test_gap_distributions():
    g = traffic.gap_pool({"process": "poisson", "rate": 4.0}, 2000)
    assert g.mean() == pytest.approx(0.25)
    assert np.std(g) == pytest.approx(0.25, rel=0.05)     # exponential
    assert np.median(g) == pytest.approx(0.25 * np.log(2), rel=0.01)


@pytest.mark.parametrize("make", [
    lambda: traffic.gap_pool({"process": "gamma", "rate": 4.0, "cv": 3.0},
                             10),
    lambda: traffic.length_pool({"dist": "fixed", "value": 9}, 5),
])
def test_unknown_shapes_are_refused(make):
    """Only the shapes the committed mixes use are generated: a mix that
    names another is refused, not served as something else."""
    with pytest.raises((ValueError, KeyError)):
        make()


def test_closed_loop_repeats_pool_in_another_order():
    t, a = items(CLOSED, 5, 16)
    first, second = a[:8], a[8:]
    assert sorted(len(x.prompt) for x in first) == sorted(
        len(x.prompt) for x in second)
    assert [len(x.prompt) for x in first] != [len(x.prompt) for x in second]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_paced_release_by_wall_clock():
    clock = FakeClock()
    t = traffic.Traffic(OPEN, 3, 1000, horizon_s=4.0)
    made = []
    w = PacedWorkload(t, t0=clock.t, stop_at=clock.t + 4.0,
                      make_request=lambda j, p, o, a: made.append(j) or j,
                      cluster_now=lambda: 0.0, clock=clock,
                      sleep=clock.sleep)
    assert w.poll(0.0) == []                    # nothing due yet
    assert w.next_arrival() == 0.0              # slept to the first due
    got = w.poll(0.0)
    assert got == [0] and clock.t == pytest.approx(100 + t.due(0))
    while w.next_arrival() is not None:
        w.poll(0.0)
    assert made == list(range(len(made)))
    assert all(s.due < 104.0 for s in w.stamps.values())
    assert w.stamps[0].due == pytest.approx(100 + t.due(0))


def test_closed_loop_client_resends_on_completion():
    clock = FakeClock()
    t = traffic.Traffic(CLOSED, 1, 1000)

    class Req:
        def __init__(self, rid):
            self.rid = rid
    w = PacedWorkload(t, t0=clock.t, stop_at=clock.t + 10,
                      make_request=lambda j, p, o, a: Req(j),
                      cluster_now=lambda: 0.0, clock=clock,
                      sleep=clock.sleep)
    first = w.poll(0.0)
    assert len(first) == 8 and w.poll(0.0) == []
    clock.t += 1.0
    w.on_complete(first[3], 0.0)
    nxt = w.poll(0.0)
    assert [r.rid for r in nxt] == [8]
    assert w.stamps[8].due == pytest.approx(101.0)


def test_closed_loop_bounds_and_capacity():
    """A cell's capacity holds the mix's longest prompt and answer, in
    whole blocks, and one block more."""
    from pbench.cell import capacity_for
    assert traffic.bounds(CLOSED["isl"]) == (32, 128)
    assert capacity_for(CLOSED, 8) == 128 + 64 + 8
    assert capacity_for(OPEN, 8) == 1920 + 96 + 8
    t, a = items(CLOSED, 4, 8)
    assert all(32 <= len(x.prompt) <= 128 and x.osl == 64 for x in a)
