"""tapir.backbone_ms: device ms per request of the operations inside TAPIR's
`_backbone_features` `record_function` ranges (ResNet and ExtraConvs), whatever their names."""

SCOPE = "_backbone_features"


def read(ctx):
  if ctx.trace is None or not ctx.window.completed:
    return None
  seconds = ctx.trace.scope_s(SCOPE)
  return 1e3 * seconds / ctx.window.completed if seconds > 0 else None
