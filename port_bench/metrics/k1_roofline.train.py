"""K1's share of its roofline over the window, in percent: the least
time of all its forward and backward calls over their device time.  A
call's least time is the larger of its FLOPs at the bf16 peak and its
bytes at the memory's.  FLOPs count the causal pairs only (4 H hd a
pair forward; the backward's five products 2.5 times that); bytes count
q, k, v and the row log-sum-exp read once and the output written once
forward, and q, k, v, o, do, lse read and dq, dk, dv written once
backward.  The shapes are the cell's: B x S tokens, the configuration's
heads.  Forward calls are counted by their kernel's records, backward
calls by the records of the one kernel each call launches once."""


def sizes(cfg: dict) -> dict:
    from port_bench.harness import load_module
    return load_module(cfg["reference"]).sizes(cfg)


def call_costs(m: dict, batch: int, seq_len: int, bytes_per=2):
    """((forward FLOPs, bytes), (backward FLOPs, bytes)) of one call."""
    B, S, H, Hk, hd = (batch, seq_len, m["num_heads"], m["num_kv_heads"],
                       m["head_dim"])
    pairs = S * (S + 1) / 2
    fwd_flops = 4 * B * H * hd * pairs
    q = B * H * S * hd * bytes_per
    kv = B * Hk * S * hd * bytes_per
    lse = B * H * S * 4
    fwd_bytes = q + 2 * kv + q + lse
    bwd_bytes = (q + 2 * kv + q + q + lse) + (q + 2 * kv)
    return (fwd_flops, fwd_bytes), (2.5 * fwd_flops, bwd_bytes)


def least_s(flops, nbytes, peaks) -> float:
    return max(flops / peaks["bf16_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    if ctx.trace is None:
        return None
    k = ctx.kernels("k1")
    tr = ctx.cell.traffic
    (ff, fb), (bf, bb) = call_costs(sizes(ctx.cell.config), tr["batch"],
                                    tr["seq_len"])
    n_fwd, us_fwd = ctx.trace.matching(k["forward"])
    n_bwd, _ = ctx.trace.matching(k["backward_calls"])
    _, us_bwd = ctx.trace.matching(k["backward"])
    if us_fwd + us_bwd <= 0:
        return None
    least = n_fwd * least_s(ff, fb, ctx.peaks) + \
        n_bwd * least_s(bf, bb, ctx.peaks)
    return 100.0 * least / ((us_fwd + us_bwd) / 1e6)
