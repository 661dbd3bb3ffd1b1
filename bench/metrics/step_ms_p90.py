"""The 90th percentile of the window's step times (host clock around a
step that ends in its loss read back and a synchronise)."""
import statistics


def read(run):
    ms = run.window.step_ms
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[-1]
