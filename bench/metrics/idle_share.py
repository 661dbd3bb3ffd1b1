"""The share of the traced window in which no operation ran on the
device: 1 - busy seconds (the device events of ``torch.profiler``'s
trace) / the traced window's seconds."""


def read(run):
    tr = run.window.trace
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
