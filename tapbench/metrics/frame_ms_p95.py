"""frame_ms_p95: the 95th percentile (nearest rank) of every stream step's
latency in the window, from the frame handed to `step` to its tracks on the
host, host clock."""

import math


def read(ctx):
  lat = sorted(ctx.window.latencies_s)
  if not lat:
    return None
  return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
