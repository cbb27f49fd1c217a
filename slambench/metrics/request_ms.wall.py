"""The client's wall time per request over the traced run's window (its
server is not profiled until the window has closed): the window's
milliseconds over the requests it finished."""

from slambench import stats


def read(readings):
    if not readings.times:
        return None
    return stats.closed_loop("request", readings.times,
                             readings.window_s)["request_ms"]
