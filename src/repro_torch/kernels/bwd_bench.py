"""K1's or K3's backward at its training shape, on a card: check, time, split.

    PYTHONPATH=src python -m repro_torch.kernels.bwd_bench [D] [B] [Hkv]    # K1
    PYTHONPATH=src python -m repro_torch.kernels.bwd_bench ssd [B] [H] [N]  # K3

Builds the kernels of the tree on ``PYTHONPATH`` (so two source trees
compare by running each under its own ``PYTHONPATH``, in turns, in one
call), draws its inputs from seed 0, then prints one line: the backward's
gradients against the plain version on the first batch row, whether two
runs agree bit for bit, its time per call from CUDA events around 10
back-to-back calls, and each of its kernels' device time per call from
``torch.profiler`` over 5 calls.  Exits 1 without a card.

* K1: bf16 q, k, v, dO at B (default 8) x S=4096 x H=32 / Hkv (default
  8, granite's; 32 is zamba2's multi-head attention) x D (default 64;
  zamba2's is 80), K1's forward with its lse first; dq, dk, dv as the
  largest error and the count over the bf16 bound 2e-2 + 2e-2 |ref|.
* K3: bf16 xdt, B, C, dy and fp32 a = dt * A at mamba2-370m's decays, at
  B (default 8) x S=4096 x H (default 32, mamba2's; zamba2's is 80) x
  P=64, N (default 128; zamba2's is 64), chunk 256, on the path
  ``select_bwd_path`` names (``wgmma``, four kernels); dx, da, dB, dC as
  the largest error over the largest entry (``chip_smoke.py``'s
  ``SSD_BWD_TOL``: 1e-2 for the bf16 outputs, 1e-4 for da).
"""
from __future__ import annotations

import re
import sys

import torch
import torch.nn.functional as F


def _time_and_split(call, kernel_re: str):
    """(ms per call from CUDA events, {kernel: device ms per call})."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(10):
        call()
    t1.record()
    t1.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        m = re.search(kernel_re, e.key)
        if m:
            us = getattr(e, "self_device_time_total", 0) or \
                getattr(e, "self_cuda_time_total", 0)
            split[m[1]] = round(us / 1e3 / 5, 3)
    return t0.elapsed_time(t1) / 10, split


def _draw(g, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


def attention(D: int = 64, B: int = 8, Hkv: int = 8) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_backward_reference
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    S, H = 4096, 32
    q, do = (_draw(g, dev, B, S, H, D).transpose(1, 2) for _ in range(2))
    k, v = (_draw(g, dev, B, S, Hkv, D).transpose(1, 2) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)

    def call():
        return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    got, again = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    exp = attention_backward_reference(
        *(t[:1] for t in (q, k, v, o, do, lse)), causal=True)
    errs = []
    for a, b in zip(got, exp):
        err = (a[:1].float() - b.float()).abs()
        over = int((err > 2e-2 + 2e-2 * b.float().abs()).sum())
        errs.append(f"{err.max().item():.3e}/{over}")
    ms, split = _time_and_split(call, r"attn_bwd_([A-Za-z0-9_]+)")
    print(f"B={B} Hkv={Hkv} D={D} ms={ms:.3f} device_ms={split} "
          f"err/over(dq,dk,dv)={errs} bitwise={same} "
          f"paths={fa.flash_attention_bwd.path_launches}", flush=True)


def ssd(B: int = 8, H: int = 32, N: int = 128) -> None:
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_chunked_backward_reference
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    S, P, Q = 4096, 64, 256
    xdt = _draw(g, dev, B, S, H, P, scale=0.3)
    bm, cm = (_draw(g, dev, B, S, N, scale=0.3) for _ in range(2))
    dy = _draw(g, dev, B, S, H, P)
    dt = F.softplus(0.64 * torch.randn(B, S, H, generator=g, device=dev))
    a = -dt * (1 + 15 * torch.rand(H, generator=g, device=dev))
    args = (xdt, a, bm, cm, dy)

    def call():
        return ss.ssd_scan_bwd(*args, chunk=Q)
    got, again = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    exp = ssd_chunked_backward_reference(*(t[:1] for t in args), Q)
    rel = lambda x, y: ((x.float() - y.float()).abs().max() /
                        y.float().abs().max()).item()
    errs = [f"{rel(x[:1], y):.3e}" for x, y in zip(got, exp)]
    ms, split = _time_and_split(call, r"ssd_bwd_(\w+?)_kernel")
    print(f"B={B} H={H} N={N} ms={ms:.3f} device_ms={split} "
          f"device_total={sum(split.values()):.3f} "
          f"rel_err(dx,da,dB,dC)={errs} bitwise={same} "
          f"launches={ss.ssd_scan_bwd.launches} "
          f"paths={ss.ssd_scan_bwd.path_launches}", flush=True)


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("bwd_bench: needs a CUDA card")
    from repro_torch.kernels import ops
    ops.build()
    if argv[:1] == ["ssd"]:
        ssd(*map(int, argv[1:4]))
    else:
        attention(*map(int, argv[:3]))


if __name__ == "__main__":
    main(sys.argv[1:])
