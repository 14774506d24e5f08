"""The 95th percentile of the wall time of every request the window
completed, each ended by its synchronise, in milliseconds.  None with
fewer than 20 requests, which leave no sample beyond it."""

import statistics


def compute(window):
    lat = [(b - a) * 1e3 for a, b in window.spans]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
