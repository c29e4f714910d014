"""frames_per_s: every video frame tracked in the window over the whole
window, host clock (a stream step tracks one frame of each stream)."""


def read(ctx):
  return ctx.window.frames / ctx.window.seconds
