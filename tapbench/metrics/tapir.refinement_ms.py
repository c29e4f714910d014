"""tapir.refinement_ms: device ms per request of the operations inside TAPIR's
`_refine_pips` `record_function` ranges (K1, K3 and the mixer's other passes), whatever their names."""

SCOPE = "_refine_pips"


def read(ctx):
  if ctx.trace is None or not ctx.window.completed:
    return None
  seconds = ctx.trace.scope_s(SCOPE)
  return 1e3 * seconds / ctx.window.completed if seconds > 0 else None
