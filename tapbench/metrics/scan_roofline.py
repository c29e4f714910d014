"""scan_roofline: the least time of the window's linear-scan calls, from each call's
shapes (`peaks.scan_bound_s`), over the device time of the kernels whose names
match `\blinear_scan` in the trace."""

PATTERN = r"\blinear_scan"


def read(ctx):
  if ctx.trace is None or not ctx.bounds or "scan" not in ctx.bounds:
    return None
  seconds = ctx.trace.kernel_s(PATTERN)
  return 100.0 * ctx.bounds["scan"] / seconds if seconds > 0 else None
