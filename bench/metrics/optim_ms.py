"""Device ms a window step spends in the optimizer's update (the step's
``optimizer.update``: AdamW over every weight)."""
SPANS = {"optim": "optimizer.update"}


def read(run):
    ms = run.window.spans.get("optim")
    if not ms or not run.steps:
        return None
    return sum(ms) / run.steps
