"""Bytes one node hands to the wire in a window step, summed over the
exchange plan's ops: the program's own tally (``sim_step``'s
``stats["wire"]``: {op: {collective: bytes}}) of the window's last
step."""


def read(run):
    wire = run.window.wire
    if not wire:
        return None
    return float(sum(b for row in wire.values() for b in row.values()))
