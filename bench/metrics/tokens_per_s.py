"""All K nodes' tokens of every step completed in the window, over the
window's seconds (host clock; each step ends when its loss is read)."""


def read(run):
    return run.tokens_per_s
