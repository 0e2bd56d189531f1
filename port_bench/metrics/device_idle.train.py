"""The share of the traced window in which no device record (kernel,
copy or set) ran, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (t.window_us - t.busy_us) / t.window_us
