"""The CG iteration's ``A @ p`` against its roofline, in percent: one
read of A's n^2 fp32 entries at the memory's peak, over the device time
per iteration of the matrix-vector kernels (names from
``kernels/cg_matvec.json``): their mean record times the records an
iteration launches (their count over the window's iterations,
rounded), so that a record the profiler drops takes its time with it."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    n = ctx.cell.config["n"]
    records, us = ctx.trace.matching(ctx.kernels("cg_matvec")["matvec"])
    if us <= 0:
        return None
    per_iter = max(1, round(records / ctx.steps))
    least_s = n * n * 4 / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (us / 1e6 / records * per_iter)
