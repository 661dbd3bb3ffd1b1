"""Device ms a window step spends in the nodes' loss and gradients
(``LGCTrainStep.node_grads``: the model's forward and backward, once per
node)."""
SPANS = {"grads": "node_grads"}


def read(run):
    ms = run.window.spans.get("grads")
    if not ms or not run.steps:
        return None
    return sum(ms) / run.steps
