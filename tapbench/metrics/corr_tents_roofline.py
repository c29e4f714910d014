"""corr_tents_roofline: the least time of the window's corr-tents calls, from each call's
shapes (`peaks.corr_bound_s`), over the device time of the kernels whose names
match `\bcorr_(tents|quantize)` in the trace."""

PATTERN = r"\bcorr_(tents|quantize)"


def read(ctx):
  if ctx.trace is None or not ctx.bounds or "corr_tents" not in ctx.bounds:
    return None
  seconds = ctx.trace.kernel_s(PATTERN)
  return 100.0 * ctx.bounds["corr_tents"] / seconds if seconds > 0 else None
