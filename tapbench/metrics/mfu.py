"""mfu: model FLOPs of the requests completed in the window (counted from
the configuration's shapes, `peaks.tapir_flops` / `tapnext_flops`) over the
window and the H100's 989 TFLOP/s dense bf16 peak, whatever the dtype."""

import peaks


def read(ctx):
  if not ctx.flops:
    return None
  return 100.0 * ctx.flops / (ctx.window.seconds * peaks.MFU_PEAK_FLOPS)
