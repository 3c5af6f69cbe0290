"""mfu.2pass: the FLOPs of the traced window's useful work over the
window times the card's peak for the configuration's type, in %: the
active slots' pass-1 steps (benchmark/lib/serving.online_step_flops), the
pass-2 forwards and the punctuation windows from their true lengths, and
the VAD rows of the streams' audio (benchmark/lib/flops.py). The rows an
engine step computes for idle slots are not useful work."""


def read(run):
    if run.trace is None or run.flops <= 0:
        return None
    return 100.0 * run.flops / (run.trace["window_s"] * run.peak_flops)
