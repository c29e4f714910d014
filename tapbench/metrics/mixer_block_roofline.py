"""mixer_block_roofline: the least time of the window's mixer-block calls, from each call's
shapes (`peaks.mixer_bound_s`), over the device time of the kernels whose names
match `\bmixer_|\bsplit_tf32\b` in the trace."""

PATTERN = r"\bmixer_|\bsplit_tf32\b"


def read(ctx):
  if ctx.trace is None or not ctx.bounds or "mixer_block" not in ctx.bounds:
    return None
  seconds = ctx.trace.kernel_s(PATTERN)
  return 100.0 * ctx.bounds["mixer_block"] / seconds if seconds > 0 else None
