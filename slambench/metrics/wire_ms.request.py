"""What a request spends outside the server's solve: the client's time of
each window request less the server's ``to_device_ms + layout_ms +
solve_ms`` for it (codec, transport, the server's loop), as a mean."""


def read(readings):
    pairs = list(zip(readings.times, readings.server_window))
    if not pairs:
        return None
    return sum(t * 1e3 - (s["to_device_ms"] + s["layout_ms"] + s["solve_ms"])
               for t, s in pairs) / len(pairs)
