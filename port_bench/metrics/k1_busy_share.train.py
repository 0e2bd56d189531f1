"""Device time of K1's kernels, forward and backward (names from
``kernels/k1.json``), over the device's busy time, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_us <= 0:
        return None
    k = ctx.kernels("k1")
    _, us = ctx.trace.matching(k["forward"] + k["backward"])
    return 100.0 * us / ctx.trace.busy_us if us > 0 else None
