"""The 90th percentile of every proof's latency in the window, from its
call to the call's synchronize (statistics.quantiles, inclusive)."""

import statistics


def read(ctx):
    lat = ctx["latencies"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
