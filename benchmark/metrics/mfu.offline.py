"""mfu.offline: the model FLOPs of the files the traced window completed
(benchmark/lib/flops.py, from the true lengths: the VAD net, the
recognizer, the punctuation model), over the window times the card's peak
for the configuration's type (benchmark/lib/chip.py), in %."""


def read(run):
    if run.trace is None or not run.served.completed or run.flops <= 0:
        return None
    return 100.0 * run.flops / (run.trace["window_s"] * run.peak_flops)
