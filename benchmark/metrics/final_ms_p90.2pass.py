"""final_ms_p90.2pass: the 90th percentile of the 2pass-offline finals'
waits sent in the window, in ms: from the server's receipt of the audio
message holding the segment's end point to the final's send (the
server's connection records, ws.final_wait)."""
from benchmark.lib import serving


def read(run):
    waits = getattr(run.served, "final_waits", None)
    v = serving.percentile(waits or [], 90)
    return None if v is None else 1000.0 * v
