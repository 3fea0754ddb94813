"""serve_overhead_ms: the mean, a frame, of the client's request time
minus the engine's time for that frame (the benchmark's span around
``EvalEngine.render_poses``, which the service calls under its lock and
which ends with the frame's copy to the host): the HTTP exchange, the
request's JSON, the npy encode and decode, the lock. Moves ``frame_ms``."""

import statistics


def read(r):
    if r.kind != "serve":
        return None
    client, render = r.host.get("client_ms", []), r.host.get("render_ms", [])
    if not client or len(client) != len(render):
        return None
    return statistics.fmean(c - s for c, s in zip(client, render))
