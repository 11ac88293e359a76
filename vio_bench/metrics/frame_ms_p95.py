"""The 95th percentile of the latency of every frame in the window, from
its first IMU sample handed over to the return of the wait for the card
after `process` (a stream's frames)."""

from vio_bench import arith


def read(run):
    lat = run.record.latencies_ms
    return arith.percentile(lat, 95) if lat else None
