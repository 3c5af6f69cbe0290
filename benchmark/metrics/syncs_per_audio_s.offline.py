"""syncs_per_audio_s.offline: the program's blocking copies to the host
(the count of its `*.fetch` spans, one copy each) over the audio seconds
of the files the traced window completed."""
from benchmark.lib import spans


def read(run):
    t = spans.totals(run)
    if t is None:
        return None
    fetch = spans.fetches(t)
    if not fetch:
        return None
    return sum(s["n"] for s in fetch) / run.served.audio_s
