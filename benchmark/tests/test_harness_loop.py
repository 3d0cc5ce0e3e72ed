"""The open and closed loops on a fake node and a fake clock: due times,
latest-wins losses, latencies."""

import pytest

from benchmark.loop import run_window


class Clock:
    """A clock that only moves when the node works or the loop sleeps."""

    def start(self):
        self.t = 0.0

    def now_ms(self):
        return self.t

    mark = now_ms

    def finish(self):
        pass

    def ms(self, mark):
        return mark

    def sleep(self, s):
        self.t += s * 1000.0


class Node:
    """Takes ``cost(k)`` ms for the frame last staged."""

    def __init__(self, clock, cost):
        self.clock, self.cost = clock, cost
        self.staged, self.taken = None, []

    def stage(self, k):
        self.staged = k

    def process(self):
        self.taken.append(self.staged)
        self.clock.t += self.cost(self.staged)
        return False


def test_open_loop_keeps_up():
    clock = Clock()
    node = Node(clock, lambda k: 10.0)
    recs, attempted, dropped = run_window(node, clock, "open", 50.0, 1.0,
                                          sleep=clock.sleep)
    assert attempted == 50 and dropped == 0
    assert [r["k"] for r in recs] == list(range(50))
    assert [r["due"] for r in recs] == pytest.approx(
        [20.0 * k for k in range(50)])
    assert all(r["latency"] == pytest.approx(10.0) for r in recs)


def test_open_loop_latest_wins():
    """A 50 ms stall on frame 2 at 50 fps: frames 3 and 4 come due during
    it and 3 is overwritten by 4 (lost); 4 waits for the stall."""
    clock = Clock()
    node = Node(clock, lambda k: 50.0 if k == 2 else 5.0)
    recs, attempted, dropped = run_window(node, clock, "open", 50.0, 0.2,
                                          sleep=clock.sleep)
    assert attempted == 10 and dropped == 1
    assert node.taken == [0, 1, 2, 4, 5, 6, 7, 8, 9]
    lat = {r["k"]: r["latency"] for r in recs}
    assert lat[2] == pytest.approx(50.0)
    # frame 4 was due at 80 ms, taken at 90 ms, done at 95 ms
    assert lat[4] == pytest.approx(15.0)
    assert lat[5] == pytest.approx(5.0)


def test_closed_loop_due_is_previous_return():
    clock = Clock()
    costs = [30.0, 10.0, 20.0]
    node = Node(clock, lambda k: costs[k % 3])
    recs, attempted, dropped = run_window(node, clock, "closed", 30.0, 0.2,
                                          sleep=clock.sleep)
    assert dropped == 0 and attempted == len(recs)
    assert sum(costs[k % 3] for k in range(attempted - 1)) < 200.0
    assert sum(costs[k % 3] for k in range(attempted)) >= 200.0
    for a, b in zip(recs, recs[1:]):
        assert b["due"] == pytest.approx(a["done"])
    assert [r["latency"] for r in recs] == pytest.approx(
        [costs[k % 3] for k in range(attempted)])


def test_unknown_loop():
    clock = Clock()
    with pytest.raises(ValueError):
        run_window(Node(clock, lambda k: 1.0), clock, "poisson", 1.0, 1.0)
