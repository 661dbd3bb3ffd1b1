"""Device ms a window step spends in the compressor and the emulated
wire (``GradientCompressor.sim_step``)."""
SPANS = {"compress": "compressor.sim_step"}


def read(run):
    ms = run.window.spans.get("compress")
    if not ms or not run.steps:
        return None
    return sum(ms) / run.steps
