"""The largest memory a resize of the window allocated over what was
allocated just before it (the allocator's peak during the drained
``dmr.reconfig`` call, less its count before the call), in GB."""


def read(ctx):
    over = [r["over_bytes"] for r in ctx.resizes]
    return max(over) / 1e9 if over else None
