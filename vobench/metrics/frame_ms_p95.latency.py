"""frame_ms_p95.latency (entry layer: OnlineVO and System.step): the
nearest-rank 95th percentile over every frame of the window of (time its
result was polled) - (time it was due to be pushed), in ms; a frame the feed
dropped counts with the age it reached unanswered."""
from vobench.arith import percentile


def read(run):
    lat = run.get("latencies_s")
    return 1e3 * percentile(lat, 95) if lat else None
