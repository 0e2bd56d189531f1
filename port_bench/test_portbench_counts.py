"""The frozen FLOP and byte counts against counts made by hand, and the
trace reduction on a trace made by hand."""
import types

import pytest

from port_bench import harness
from port_bench.trace_reduce import Trace

GRANITE_CFG = harness.load_json(harness.BENCH_DIR / "configs" /
                                "granite-3-2b.json")
GRANITE = harness.load_module("refs/dense_lm.py").sizes(GRANITE_CFG)
PEAKS = harness.load_json(harness.BENCH_DIR / "peaks.json")


def test_granite_step_flops():
    mfu = harness.load_module("metrics/step_mfu.train.py")
    # weights in matrix products: per layer q, k, v (2048 x 48 x 64), o
    # (2048 x 2048) and the MLP (3 x 2048 x 8192); the tied unembedding
    n = 40 * (2048 * 48 * 64 + 2048 * 2048 + 3 * 2048 * 8192) + 49280 * 2048
    assert n == 2_533_621_760
    pairs = 8 * 4096 * 4097 // 2            # causal pairs, 8 rows
    attn = 40 * 3 * 4 * 32 * 64 * pairs
    hand = 6 * n * 32768 + attn
    assert mfu.step_flops(GRANITE, 8, 4096) == pytest.approx(hand, rel=1e-12)
    assert hand == pytest.approx(5.641e14, rel=1e-3)
    # 32 x 1024: the same tokens, a quarter of the pairs a token
    pairs_1k = 32 * 1024 * 1025 // 2
    hand_1k = 6 * n * 32768 + 40 * 3 * 4 * 32 * 64 * pairs_1k
    assert mfu.step_flops(GRANITE, 32, 1024) == pytest.approx(hand_1k,
                                                              rel=1e-12)


def test_granite_sizes_come_from_the_source_keys():
    """The reference and the program run the widths of the source's
    keys: the reference reads them, and the driver's ArchConfig takes
    them from the reference's reading, so ``program`` holds no width."""
    assert GRANITE == dict(num_layers=40, d_model=2048, num_heads=32,
                           num_kv_heads=8, head_dim=64, d_ff=8192,
                           vocab_size=49155, vocab_phys=49280,
                           rope_theta=10000.0, norm_eps=1e-05)
    lm = harness.load_module("drivers/lm_train.py")
    arch = lm.arch_config(GRANITE_CFG, GRANITE)
    assert (arch.num_layers, arch.d_model, arch.num_heads, arch.num_kv_heads,
            arch.head_dim, arch.d_ff, arch.vocab_size) == (
        40, 2048, 32, 8, 64, 8192, 49155)
    assert arch.tie_embeddings and arch.dtype == "bfloat16"
    from repro_torch.configs.base import phys_vocab
    assert phys_vocab(arch.vocab_size) == GRANITE["vocab_phys"]


def test_k1_call_costs_match_the_kernel_table():
    k1 = harness.load_module("metrics/k1_roofline.train.py")
    (ff, fb), (bf, bb) = k1.call_costs(GRANITE, 8, 4096)
    assert ff == 4 * 8 * 32 * 64 * (4096 * 4097 / 2)
    assert bf == 2.5 * ff
    # q and o (8 x 32 x 4096 x 64 bf16), k and v (8 heads), lse fp32
    q = 8 * 32 * 4096 * 64 * 2
    kv = 8 * 8 * 4096 * 64 * 2
    assert fb == 2 * q + 2 * kv + 8 * 32 * 4096 * 4
    # PERF.md's table: 0.556 ms forward, 1.390 ms backward (operations)
    assert k1.least_s(ff, fb, PEAKS) * 1e3 == pytest.approx(0.556, abs=1e-3)
    assert k1.least_s(bf, bb, PEAKS) * 1e3 == pytest.approx(1.390, abs=1e-3)


def test_cg_matvec_bound():
    n = harness.load_json(harness.BENCH_DIR / "configs" /
                          "cg-32768.json")["n"]
    assert n * n * 4 / PEAKS["hbm_bytes_per_s"] * 1e3 == pytest.approx(
        1.282, abs=1e-3)


def _ev(name, start, end, device=False, kernels=()):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        kernels=list(kernels), cpu_children=[], cpu_parent=None,
        sequence_nr=-1, thread=0, fwd_thread=0, id=id(name) + start)


def test_trace_busy_idle_and_matching():
    evs = [_ev("bench.window", 0, 100),
           _ev("bench.step", 0, 40), _ev("bench.loss_read", 40, 60),
           _ev("bench.reconfig", 60, 100),
           _ev("attn_mma_kernel<64>", 10, 30, device=True),
           _ev("gemv2T_kernel", 25, 35, device=True),     # overlaps
           _ev("bench.step", 50, 55, device=True),        # a span's record
           _ev("Memcpy DtoD", 70, 80, device=True)]
    prof = types.SimpleNamespace(events=lambda: evs)
    t = Trace(prof)
    assert t.window_us == 100
    assert t.busy_us == 25 + 10                            # [10, 35], [70, 80]
    assert t.matching(["attn_mma_kernel"]) == (1, 20)
    # gaps [0, 10) and [35, 70) begin inside bench.step, [80, 100) inside
    # bench.reconfig
    assert t.idle_by_span() == {"bench.step": 10 + 35, "bench.reconfig": 20}
    b = t.breakdown()
    assert b["device_ops"][0] == ["attn_mma_kernel<64>", 20e-6]
    assert len(b["idle_gaps"]) <= 10
