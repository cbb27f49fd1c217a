"""The server's per-request layout (``GaussNewton._prepare``: the gather
tables of the request's graph), as a mean over the window's requests."""


def read(readings):
    window = readings.server_window
    if not window:
        return None
    return sum(s["layout_ms"] for s in window) / len(window)
