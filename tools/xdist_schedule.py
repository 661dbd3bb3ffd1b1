"""Replay a test run's junit timings through pytest-xdist's
``--dist loadfile`` scheduler, to see which worker ends last and why.

    python tools/xdist_schedule.py RUN.xml [--workers 6] [--noise 0.15]

xdist (3.x) queues the files by their number of tests, most first (ties
in collection order: by name), hands each worker one file, and gives a
worker the next file when it has at most 2 tests left.  So a file's
place in the queue is set by its test count, not its length: a long
file with few tests starts late, and two of the reference's long files
(test_transports, test_chaos, test_overlap: ~750-900 s of junit time
each) on one worker overrun the 1470 s limit.  Prints each worker's
files and finishing time for the run as recorded; with ``--noise`` also
the finishing time's median and 90th and 97th percentiles over 300
draws of independent per-test factors lognormal(0, noise) times a common
factor lognormal(0, 0.1).  The junit times are wall times under the
run's own contention, so the replay reads how that run was placed.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import random
import xml.etree.ElementTree as ET


def load(path):
    """{file: [test seconds in collection order]} from a junit XML."""
    files = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        f = tc.get("classname").split(".")[-1]
        files.setdefault(f, []).append(float(tc.get("time")))
    return files


def replay(files, workers: int = 6):
    """(finish seconds per worker, file names per worker)."""
    queue = collections.deque(sorted(sorted(files),
                                     key=lambda f: -len(files[f])))
    pend = [collections.deque() for _ in range(workers)]
    names = [[] for _ in range(workers)]

    def assign(w):
        f = queue.popleft()
        names[w].append(f)
        pend[w].extend(files[f])

    for w in range(workers):
        if queue:
            assign(w)
    for w in range(workers):
        if queue and len(pend[w]) <= 2:
            assign(w)
    events = [(pend[w][0], w) for w in range(workers) if pend[w]]
    heapq.heapify(events)
    finish = [0.0] * workers
    while events:
        t, w = heapq.heappop(events)
        pend[w].popleft()
        finish[w] = t
        if queue and len(pend[w]) <= 2:
            assign(w)
        if pend[w]:
            heapq.heappush(events, (t + pend[w][0], w))
    return finish, names


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("junit")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--noise", type=float, default=0.0)
    a = p.parse_args(argv)
    files = load(a.junit)
    finish, names = replay(files, a.workers)
    for t, fs in sorted(zip(finish, names), reverse=True):
        print(f"{t:8.1f} s  " + ", ".join(
            f"{f} ({len(files[f])}, {sum(files[f]):.0f} s)" for f in fs))
    print(f"serial {sum(map(sum, files.values())):.1f} s, "
          f"replayed end {max(finish):.1f} s")
    if a.noise:
        ends = []
        for seed in range(300):
            r = random.Random(seed)
            common = r.lognormvariate(0, 0.1)
            drawn = {f: [x * common * r.lognormvariate(0, a.noise)
                         for x in v] for f, v in files.items()}
            ends.append(max(replay(drawn, a.workers)[0]))
        ends.sort()
        print("noise {}: median {:.0f} s, p90 {:.0f} s, p97 {:.0f} s".format(
            a.noise, *(ends[int(len(ends) * q)] for q in (0.5, 0.9, 0.97))))


if __name__ == "__main__":
    main()
