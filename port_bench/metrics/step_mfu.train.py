"""The window's model FLOPs over its length times the card's bf16 peak,
in percent.  Model FLOPs are counted here from the configuration's
sizes, frozen: 6 per weight of the matrix products a token (the tied
unembedding included, the embedding lookup not) and the causal
attention's two products forward and backward; recomputation is not
counted."""


def sizes(cfg: dict) -> dict:
    from port_bench.harness import load_module
    return load_module(cfg["reference"]).sizes(cfg)


def flops_per_token(m: dict, seq_len: int) -> float:
    L, D, F = m["num_layers"], m["d_model"], m["d_ff"]
    H, Hk, hd, Vp = (m["num_heads"], m["num_kv_heads"], m["head_dim"],
                     m["vocab_phys"])
    matmul_weights = L * (D * (H + 2 * Hk) * hd + H * hd * D + 3 * D * F) \
        + Vp * D
    causal_pairs_per_token = (seq_len + 1) / 2
    attention = L * 3 * 4 * H * hd * causal_pairs_per_token
    return 6 * matmul_weights + attention


def step_flops(m: dict, batch: int, seq_len: int) -> float:
    return flops_per_token(m, seq_len) * batch * seq_len


def read(ctx):
    tr = ctx.cell.traffic
    flops = step_flops(sizes(ctx.cell.config), tr["batch"],
                       tr["seq_len"]) * ctx.steps
    if not ctx.steps or ctx.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bf16_flops_per_s"])
