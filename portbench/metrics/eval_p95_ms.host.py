"""The 95th percentile of latency over every eval completed in the
window, ms, from the host's clock in the load generator: a per-layer
metric where the tail spreads too widely between runs to hold a bound."""
import spec


def read(ctx):
    lat = ctx["latencies"]
    return 1e3 * spec.percentile(lat, 95) if lat else None
