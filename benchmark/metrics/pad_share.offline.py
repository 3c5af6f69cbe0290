"""pad_share.offline: the share of the recognizer's forward rows x frames
that is padding, in %: 1 - asr.frames / asr.frames_padded, the program's
counters over the traced window's completed files (each forward chunk
adds its rows' true LFR frames and its rows times its length bucket)."""
from benchmark.lib import spans


def read(run):
    t = spans.totals(run)
    if t is None or not t["counts"].get("asr.frames_padded"):
        return None
    c = t["counts"]
    return 100.0 * (1.0 - c["asr.frames"] / c["asr.frames_padded"])
