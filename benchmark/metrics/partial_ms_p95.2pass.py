"""partial_ms_p95.2pass: the 95th percentile of the 2pass-online partials'
waits sent in the window, in ms: from the server's receipt of the audio
message holding the last sample the partial's 600 ms chunk needs to the
partial's send (the server's connection records, ws.partial_wait)."""
from benchmark.lib import serving


def read(run):
    waits = getattr(run.served, "partial_waits", None)
    v = serving.percentile(waits or [], 95)
    return None if v is None else 1000.0 * v
