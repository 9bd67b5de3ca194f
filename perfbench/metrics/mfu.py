"""mfu: the crossbar arithmetic every datapoint of the window needs, the
metered sweep's count (``yardstick.work.metered_sweep``: its K/2 driven
rows over the nonempty clause columns, the clause meter, the class
rows), over the window's seconds times the H100's dense f32 peak (67
TFLOP/s: the configurations state IEEE f32 currents), in percent."""
from perfbench.yardstick.work import PEAK_F32_FLOPS


def read(run):
    return (100.0 * run.datapoints * run.flops_per_datapoint
            / (run.window_s * PEAK_F32_FLOPS))
