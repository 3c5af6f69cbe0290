"""fetch_wait_share.offline: the share of the requests' host time spent
in the program's fetch spans (`*.fetch`, each one blocking copy to the
host, which waits for the card's queued work), in %: the fetch spans'
total over the `offline.request` spans' total."""
from benchmark.lib import spans


def read(run):
    t = spans.totals(run)
    if t is None or "offline.request" not in t["spans"]:
        return None
    fetch = spans.fetches(t)
    if not fetch:
        return None
    req = t["spans"]["offline.request"]["total_ns"]
    return 100.0 * sum(s["total_ns"] for s in fetch) / req
