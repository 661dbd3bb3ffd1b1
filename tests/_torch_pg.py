"""Shared by the port's process-group tests (tests/test_torch_pg_*.py):
launch K processes on one gloo process group, each told its RANK,
WORLD_SIZE and LOCAL_RANK as torchrun would, meeting through a file
store under the test's tmp dir (never a fixed TCP port: the suite's
xdist workers share the machine), each on one torch thread, the whole
launch killed at its own timeout so that a deadlock fails in seconds."""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(tmp, argv, K: int, timeout: float = 120.0):
    """Run ``argv`` (a command list; ``{store}`` in it becomes the store's
    file:// URL) as ranks 0..K-1; returns their stdouts.  Raises with
    every rank's output tail if any rank fails or the launch outlives
    ``timeout`` seconds, after killing all of them."""
    store = os.path.join(str(tmp), "pg_store")
    if os.path.exists(store):
        os.remove(store)
    url = "file://" + store
    argv = [a.replace("{store}", url) for a in argv]
    base = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(K),
                PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
                + os.path.join(REPO, "tests"))
    logs = [open(os.path.join(str(tmp), f"rank{r}.log"), "w+")
            for r in range(K)]
    procs = [subprocess.Popen(
        argv, stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r))) for r in range(K)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            if time.monotonic() > deadline:
                failed = f"the launch outlived its {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise AssertionError(f"{failed}:\n{tails}")
    return outs


def worker(script: str):
    """The command that runs a script of tests/ by path."""
    return [sys.executable, os.path.join(REPO, "tests", script)]
