"""setup_s: process start to the first timed request, host clock: imports,
CUDA context, kernels loaded from the build cache, weights, the cell's
traffic made from the seed, and the warm-up of the cell's own shapes."""


def read(ctx):
  return ctx.setup_s
