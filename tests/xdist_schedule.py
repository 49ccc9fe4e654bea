"""Where the Tier-1 run's wall time goes under pytest-xdist, and what the
collected count N does to it.

The Tier-1 command runs ``--dist load`` on 6 workers, and its wall is
the worker that ends last.  xdist's ``LoadScheduling`` hands out
consecutive chunks whose sizes follow from the count of pending tests,
so N decides which worker draws the reference's long
``test_multichip`` / ``test_multiprocess`` cases in a row.

1. Record every test's start and end, per worker (a pytest plugin)::

       XDIST_TIMELINE_DIR=/tmp/tl PYTHONPATH=tests <the Tier-1 command> -p xdist_schedule

2. Replay the scheduler on those durations for N - k .. N + k (fast
   dummy tests inserted or removed after the last test of
   ``--anchor``)::

       python -m pytest tests/ -m 'not slow' --collect-only -q -n0 | grep :: > /tmp/c.txt
       python tests/xdist_schedule.py /tmp/tl /tmp/c.txt [--span 40] [--anchor test_torch_mesh]

The replay models the scheduler's own rules (initial chunks of
N / workers / 4, refills to half the pending share when a worker falls
below a quarter, none while a worker still holds two tests after a long
one); it ignores the workers' start-up and a worker that dies.
"""

from __future__ import annotations

import argparse
import glob
import heapq
import json
import os
import time

_fh = None


def pytest_runtest_logstart(nodeid, location):
    global _fh
    out = os.environ.get("XDIST_TIMELINE_DIR")
    if not out:
        return
    if _fh is None:
        os.makedirs(out, exist_ok=True)
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        _fh = open(os.path.join(out, f"{worker}.jsonl"), "a")
    _fh.write(json.dumps({"n": nodeid, "s": time.time()}) + "\n")
    _fh.flush()


def pytest_runtest_logfinish(nodeid, location):
    if _fh is not None:
        _fh.write(json.dumps({"n": nodeid, "e": time.time()}) + "\n")
        _fh.flush()


def durations(timeline_dir: str) -> dict:
    """Each test's seconds from logstart to logfinish (fixtures in)."""
    out = {}
    for path in glob.glob(os.path.join(timeline_dir, "gw*.jsonl")):
        events = {}
        with open(path) as fh:
            for line in fh:
                d = json.loads(line)
                events.setdefault(d["n"], {}).update(d)
        out.update({n: d["e"] - d["s"] for n, d in events.items()
                    if "e" in d and "s" in d})
    return out


def replay(order, dur, workers=6, unknown=0.5):
    """The makespan of ``LoadScheduling`` over the tests ``order`` with
    the seconds ``dur``: ``(wall, per-worker end)``."""
    pending = list(range(len(order)))
    queue = [[] for _ in range(workers)]

    def send(k, num):
        queue[k].extend(pending[:num])
        del pending[:num]

    chunk = max(len(order) // workers // 4, 2)
    for k in range(workers):
        send(k, chunk)
    heap, end = [], [0.0] * workers

    def start(k, now):
        if queue[k]:
            i = queue[k][0]
            heapq.heappush(heap, (now + dur.get(order[i], unknown), k, i))

    for k in range(workers):
        start(k, 0.0)
    while heap:
        now, k, i = heapq.heappop(heap)
        queue[k].remove(i)
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            long_test = dur.get(order[i], unknown) >= 0.1
            if len(queue[k]) < lo and not (long_test and len(queue[k]) >= 2):
                send(k, hi - len(queue[k]))
        end[k] = now
        start(k, now)
    return max(end), end


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("timeline_dir")
    parser.add_argument("collected", help="file of collected node ids")
    parser.add_argument("--span", type=int, default=40)
    parser.add_argument("--anchor", default="test_torch_mesh")
    parser.add_argument("--workers", type=int, default=6)
    args = parser.parse_args(argv)
    with open(args.collected) as fh:
        order = [ln.strip() for ln in fh if "::" in ln]
    dur = durations(args.timeline_dir)
    wall, ends = replay(order, dur, args.workers)
    print(f"N {len(order)}: wall {wall:.0f} s, worker ends "
          f"{[round(e) for e in ends]}")
    at = [i for i, n in enumerate(order) if args.anchor in n]
    for k in range(-args.span, args.span + 1):
        o = list(order)
        if k > 0:
            o[at[-1] + 1:at[-1] + 1] = [f"dummy::{j}" for j in range(k)]
            dur.update({f"dummy::{j}": 0.05 for j in range(k)})
        elif k < 0:
            drop = set(at[:-k])
            o = [n for i, n in enumerate(o) if i not in drop]
        print(f"N {len(o)}: wall {replay(o, dur, args.workers)[0]:.0f} s")


if __name__ == "__main__":
    main()
