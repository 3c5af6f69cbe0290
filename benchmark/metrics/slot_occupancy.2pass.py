"""slot_occupancy.2pass: the share of the pass-1 rows computed in the
window that advanced a stream, in %: the engine's counters
engine.p1_active over engine.p1_rows (each fused step computes every
slot of the engine's capacity)."""


def read(run):
    counts = getattr(run.served, "counts", None) or {}
    rows = counts.get("engine.p1_rows", 0)
    if rows <= 0:
        return None
    return 100.0 * counts.get("engine.p1_active", 0) / rows
