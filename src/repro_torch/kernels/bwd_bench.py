"""K1's backward at the training shape, on a card: check, time, split.

    PYTHONPATH=src python -m repro_torch.kernels.bwd_bench [D] [B]

Builds the kernels of the tree on ``PYTHONPATH`` (so two source trees
compare by running each under its own ``PYTHONPATH``, in turns, in one
call), draws bf16 q, k, v, dO from seed 0 at B x S=4096 x H=32 / Hkv=8 x D
(default D=64, B=8), runs K1's forward with its lse, then prints one line:
the backward's dq, dk, dv against the plain version on the first batch
row (largest error and the count over the bf16 bound 2e-2 + 2e-2 |ref|),
whether two runs agree bit for bit, its time per call from CUDA events
around 10 back-to-back calls, and each of its three kernels' device time
per call from ``torch.profiler`` over 5 calls.  Exits 1 without a card.
"""
from __future__ import annotations

import sys

import torch


def main(D: int = 64, B: int = 8) -> None:
    if not torch.cuda.is_available():
        sys.exit("bwd_bench: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_backward_reference
    ops.build()
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    S, H, Hkv = 4096, 32, 8

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    q, do = (draw(B, S, H, D).transpose(1, 2) for _ in range(2))
    k, v = (draw(B, S, Hkv, D).transpose(1, 2) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    exp = attention_backward_reference(
        *(t[:1] for t in (q, k, v, o, do, lse)), causal=True)
    errs = []
    for a, b in zip(got, exp):
        err = (a[:1].float() - b.float()).abs()
        over = int((err > 2e-2 + 2e-2 * b.float().abs()).sum())
        errs.append(f"{err.max().item():.3e}/{over}")

    def call():
        return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
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
        if "attn_bwd" in e.key:
            us = getattr(e, "self_device_time_total", 0) or \
                getattr(e, "self_cuda_time_total", 0)
            name = e.key.split("attn_bwd_")[1].split("<")[0].split("(")[0]
            split[name] = round(us / 1e3 / 5, 3)
    print(f"B={B} D={D} ms={t0.elapsed_time(t1) / 10:.3f} device_ms={split} "
          f"err/over(dq,dk,dv)={errs} bitwise={same} "
          f"paths={fa.flash_attention_bwd.path_launches}", flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
