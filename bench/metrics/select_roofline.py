"""The error-feedback accumulate and top-k of one node
(``GradientCompressor._accumulate_select``) against the chip's memory
bandwidth: the bytes the operation needs (``lgcbench.counts``), over the
device's peak bytes/s, over the call's device span, summed over the
window's calls."""
from lgcbench import counts, hw

SPANS = {"select": "compressor._accumulate_select"}


def read(run):
    ms = run.window.spans.get("select")
    bw = hw.peak(run.device_name, "hbm_bytes_per_s")
    if not ms or bw is None:
        return None
    need = counts.select_bytes(run.cell.spec,
                               run.cell.cfg["compression"]["sparsity"])
    return 100.0 * len(ms) * need / bw / (sum(ms) / 1e3)
