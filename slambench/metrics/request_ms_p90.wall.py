"""The 90th percentile of the client's wall time of each request in the
traced run's window (its server is not profiled until the window has
closed)."""

from slambench import stats


def read(readings):
    if not readings.times:
        return None
    return stats.closed_loop("request", readings.times,
                             readings.window_s)["request_ms_p90"]
