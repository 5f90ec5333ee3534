"""Mean milliseconds from a request's submit to the start of the dispatch
that answered it (the last dispatch to end before the answer arrived)."""

from statistics import mean


def read(run):
    return mean(run["queue_ms"]) if run["queue_ms"] else None
