"""The device's idle share of the traced window: 1 - (the union of its
operation intervals, `gpu_user_annotation` ranges left out) / the window."""


def read(ctx):
  if ctx.trace is None:
    return None
  return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
