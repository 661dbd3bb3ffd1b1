"""The whole step's share of the chip's dense bf16 peak: 6 N tokens/s
(N the configuration's weights, counted from its shapes) over the
window, against ``lgcbench.hw``'s peak for the device."""
from lgcbench import counts, hw


def read(run):
    peak = hw.peak(run.device_name, "bf16_flops")
    if peak is None or not run.steps:
        return None
    return 100.0 * counts.train_flops(run.cell.spec, 1) \
        * run.tokens_per_s / peak
