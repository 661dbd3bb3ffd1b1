"""Process start to the first timed step: imports, the weights and
batches drawn from the seed, the kernels' build where it is not cached
yet, and the set-up steps."""


def read(run):
    return run.setup_s
