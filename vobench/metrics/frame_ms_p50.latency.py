"""frame_ms_p50.latency: the median of the same per-frame latencies as
frame_ms_p95.latency (entry layer: OnlineVO and System.step), in ms."""
from vobench.arith import percentile


def read(run):
    lat = run.get("latencies_s")
    return 1e3 * percentile(lat, 50) if lat else None
