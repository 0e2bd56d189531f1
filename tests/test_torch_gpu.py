"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test skips, with a reason, when no CUDA card is
present (decided in a fixture at run time, never at import).  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``tests/test_kernels.py``: for attention 2e-5
for float32 (every path computes fp32 inputs in fp32 FMAs, never TF32) and
2e-2 for bfloat16 (absolute plus relative); for the SSD scan 5e-4 and 3e-2 against the sequential oracle;
the repack is exact.  Against the chunked plain version, which runs the
kernel's own algorithm in fp32, the SSD scan is held to ``SSD_CHUNKED_TOL``
(see there); K3's wgmma path (bf16 on the tensor cores) is held to the
same bounds.
"""
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ops
from repro_torch.kernels import blockcyclic as bc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference,
                                     attention_reference, repack_reference,
                                     ssd_chunked_backward_reference,
                                     ssd_chunked_reference, ssd_reference)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

ATTN_CASES = [
    # (B, H, Hkv, Sq, Sk, D, causal, window, dtype) — tests/test_kernels.py,
    # plus ragged lengths the Pallas wrapper cannot take
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 8, 8, 128, 128, 128, False, 0, "float32"),
    (2, 4, 1, 256, 256, 64, True, 64, "float32"),
    (1, 2, 2, 128, 128, 64, True, 0, "bfloat16"),
    (1, 4, 2, 64, 64, 32, True, 0, "float32"),
    (3, 4, 2, 1, 200, 64, False, 0, "float32"),
    (2, 4, 2, 77, 77, 64, True, 0, "bfloat16"),
    (2, 4, 2, 40, 40, 16, True, 0, "float32"),       # the smoke config's D
]
# (B, H, Hkv, Sq, Sk, causal, window, dtype): each path at every head dim,
# with ragged edges, windows and Sq < Sk (top-left causal)
PATH_CASES = [
    (2, 8, 2, 77, 77, True, 0, "bfloat16"),          # mma, ragged
    (1, 4, 2, 200, 256, True, 64, "bfloat16"),       # mma, window, Sq < Sk
    (1, 4, 4, 130, 130, False, 0, "bfloat16"),       # mma, Hkv = H
    (2, 8, 2, 40, 90, True, 0, "float32"),           # fma, Sq < Sk
    (1, 4, 1, 70, 70, True, 16, "float32"),          # fma, window, Hkv = 1
    (3, 8, 2, 1, 200, False, 0, "float32"),          # split_decode
    (3, 8, 1, 1, 333, False, 0, "bfloat16"),         # split_decode, G = 8
    (2, 4, 2, 3, 150, True, 0, "bfloat16"),          # split_decode, Sq = 3
    (2, 4, 2, 4, 150, True, 40, "float32"),          # split_decode, window
    # non-causal with Sq != Sk (encoder-decoder cross-attention), at G = 1
    (2, 4, 4, 100, 260, False, 0, "bfloat16"),       # mma, Sq < Sk
    (2, 8, 2, 260, 100, False, 0, "bfloat16"),       # mma, Sq > Sk
    (2, 4, 4, 70, 150, False, 0, "float32"),         # fma, Sq < Sk
    (2, 8, 2, 150, 70, False, 0, "float32"),         # fma, Sq > Sk
]
# (B, H, Hkv, Sq, Sk, causal, window), bf16: with B * Hkv >= 66 on a
# 132-SM card the mma path runs its group kernel (one CTA per batch and KV
# head); the mma cases of PATH_CASES run its block kernel
GROUP_CASES = [
    (16, 32, 8, 256, 256, True, 0),
    (16, 32, 8, 200, 200, True, 50),
    (16, 32, 8, 100, 256, True, 0),                  # Sq < Sk
    (16, 8, 8, 130, 130, False, 0),                  # Hkv = H, ragged
    (70, 4, 1, 64, 64, True, 0),                     # Hkv = 1
    (16, 24, 8, 256, 256, True, 0),                  # phi4-mini's prefill
    (16, 16, 16, 200, 256, False, 0),                # cross, Sq < Sk, G = 1
    (16, 16, 16, 256, 130, False, 0),                # cross, Sq > Sk, G = 1
]
# K1 at head dim 128 with the GQA ratios of the dense configs (phi4-mini
# G = 3, qwen2.5 G = 5, internlm2 G = 6), on each kernel: (B, Hkv, Sq, Sk,
# causal) -- split_decode over a 512-slot cache at kv_lens around tile
# edges, the mma path's group kernel (2 B Hkv >= the SMs, 4 tiles: the
# most it holds at D = 128) and its block kernel (few CTAs, 5 tiles)
GQA_RATIOS = (3, 5, 6)
GQA_KERNELS = {"split_decode": (16, 8, 1, 512, False),
               "group": (16, 8, 256, 256, True),
               "block": (2, 2, 300, 300, True)}

# K1's backward: (B, H, Hkv, Sq, Sk, causal, window), every head dim and
# dtype; GQA, Hkv = H, windows, Sq = Sk not a multiple of 64, Sq < Sk
BWD_CASES = [
    (2, 4, 2, 256, 256, True, 0),
    (1, 4, 1, 200, 200, True, 0),
    (2, 8, 2, 77, 77, True, 40),
    (1, 4, 4, 130, 130, False, 0),
    (1, 4, 2, 100, 160, True, 0),
    (1, 2, 2, 64, 64, False, 24),
    (1, 4, 4, 100, 200, False, 0),                   # cross, Sq < Sk, G = 1
    (2, 8, 2, 190, 70, False, 0),                    # cross, Sq > Sk
]
#: the backward against its plain version: both fp32 from the same inputs
#: and lse, differing in summation order over up to G * Sq products per
#: dk / dv entry (~1e-5 at these lengths), so 1e-4; bf16 outputs are
#: rounded once to 8 bits (2^-8 relative), as the forward's 2e-2
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

REPACK_CASES = [(16, 8, 32, 10), (8, 16, 16, 8), (32, 8, 128, 32), (7, 3, 5, 9)]
# (nblocks, block, width, dtype, idx): the bulk path (16-byte blocks) with a
# block smaller than one 32 KB stage, a block of several stages with a
# ragged last one, nout far above the SM count, repeated and reversed
# indices, nout = 0; then the bytes path (blocks of 15 and 9 bytes)
REPACK_PATH_CASES = [
    (16, 8, 32, "float32", "perm", "bulk"),          # 1 KB blocks
    (12, 50, 1000, "float32", "perm", "bulk"),       # 200 KB: 6.25 stages
    (300, 4, 16, "bfloat16", "many", "bulk"),        # nout = 3000
    (9, 64, 2048, "float32", "repeat", "bulk"),      # 512 KB, repeated
    (40, 16, 64, "float32", "reverse", "bulk"),
    (5, 8, 32, "float32", "empty", "bulk"),          # nout = 0
    (20, 3, 5, "uint8", "many", "bytes"),            # 15-byte blocks
    (6, 9, 1, "uint8", "reverse", "bytes"),
]

# K3's wgmma path: every P x N x Q, S of 1 to 4 chunks
SSD_WGMMA_CASES = [(P, N, Q, 1 + (i % 4)) for i, (P, N, Q) in enumerate(
    (P, N, Q) for P in (16, 32, 64) for N in (16, 64, 128)
    for Q in (64, 128, 256))]

SSD_CASES = [
    # (B, H, S, P, N, Q, decay, dtype) — tests/test_kernels.py (decay 0.4),
    # plus a chunk that is not a multiple of the kernel's 64-row tile, the
    # smoke config, and the serving path's P, N, Q; decay 0.02 keeps the
    # state alive across chunks, so the carry is exercised; "model" draws
    # a = dt * A as mamba2's init does (in-chunk cumsums reach ~-3e3)
    (2, 4, 256, 32, 16, 64, 0.4, "float32"),
    (1, 2, 128, 64, 128, 32, 0.4, "float32"),
    (1, 2, 128, 32, 16, 128, 0.4, "float32"),
    (2, 2, 64, 16, 16, 16, 0.4, "bfloat16"),
    (2, 3, 144, 48, 32, 48, 0.02, "float32"),
    (2, 4, 64, 16, 16, 32, 0.02, "float32"),
    (2, 4, 768, 64, 128, 256, 0.02, "bfloat16"),
    (1, 2, 512, 64, 128, 256, 0.02, "float32"),
    (1, 32, 512, 64, 128, 256, "model", "float32"),
]
SSD_TOL = {"float32": 5e-4, "bfloat16": 3e-2}
#: kernel vs the chunked plain version: the same algorithm in fp32,
#: differing only in summation order.  The in-chunk cumsum's order matters
#: most: at mamba2's decays it reaches ~-3e3 (fp32 step 2.4e-4), which
#: enters exp(cum_q - cum_s) directly and moves y by ~1e-4 (chip_smoke's
#: model_decay_err_vs_chunked), so f32 keeps the oracle's 5e-4; in bf16 both round the same fp32 value to 8
#: bits, so they differ by at most one bf16 step (2^-7 relative)
SSD_CHUNKED_TOL = {"float32": 5e-4, "bfloat16": 1e-2}


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window,dtype", ATTN_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, B, H, Hkv, Sq, Sk, D,
                                            causal, window, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt) for s in
               [(B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)])
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    exp = attention_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _expect(B, H, Hkv, Sq, dtype):
    return fa.select_path(getattr(torch, dtype), H // Hkv * Sq)


@pytest.mark.gpu
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,window,dtype", PATH_CASES)
def test_flash_paths_every_head_dim_on_card(cuda, B, H, Hkv, Sq, Sk, causal,
                                            window, dtype, D):
    g = torch.Generator(cuda).manual_seed(2)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt) for s in
               [(B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)])
    path = _expect(B, H, Hkv, Sq, dtype)
    before = dict(fa.flash_attention.path_launches)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa.flash_attention.path_launches
    assert {p: after[p] - before[p] for p in after} == \
        {p: int(p == path) for p in after}
    exp = attention_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,window", GROUP_CASES)
def test_flash_group_prefill_on_card(cuda, B, H, Hkv, Sq, Sk, causal, window,
                                     D):
    g = torch.Generator(cuda).manual_seed(4)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16() for s in
               [(B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)])
    before = fa.flash_attention.path_launches["mma"]
    mma_before = fa.mma_kernel_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.path_launches["mma"] == before + 1
    mma_after = fa.mma_kernel_launches()        # as the C entry counts them
    assert {k_: mma_after[k_] - mma_before[k_] for k_ in mma_after} == \
        {"block": 0, "group": 1}
    exp = attention_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dtype", [("split_decode", "bfloat16"),
                                          ("split_decode", "float32"),
                                          ("group", "bfloat16"),
                                          ("block", "bfloat16")])
@pytest.mark.parametrize("G", GQA_RATIOS)
def test_flash_gqa_ratios_at_head_dim_128_on_card(cuda, G, kernel, dtype):
    """Query rows per KV head that are not a power of two (G * Sq = 3, 5,
    6 of split_decode's 16 rows; G query heads per group CTA) against the
    plain version, each call on the path and kernel its shape selects."""
    B, Hkv, Sq, Sk, causal = GQA_KERNELS[kernel]
    D, H, dt = 128, G * Hkv, getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(G)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
            for _ in range(2))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    lens = [1, 63, 64, 65, 255, 384, 512] if kernel == "split_decode" \
        else [None]
    path = "split_decode" if kernel == "split_decode" else "mma"
    assert _expect(B, H, Hkv, Sq, dtype) == path
    before = dict(fa.flash_attention.path_launches)
    mma_before = fa.mma_kernel_launches()
    for n in lens:
        kw = dict(causal=causal) if n is None else dict(
            causal=False, kv_len=torch.tensor(n, dtype=torch.int32,
                                              device=cuda))
        out = ops.flash_attention(*args, **kw)
        exp = attention_reference(*args, **kw)
        torch.testing.assert_close(out.float(), exp.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    after = fa.flash_attention.path_launches
    assert {p: after[p] - before[p] for p in after} == \
        {p: len(lens) * (p == path) for p in after}
    mma_after = fa.mma_kernel_launches()        # as the C entry counts them
    assert {k_: mma_after[k_] - mma_before[k_] for k_ in mma_after} == \
        {k_: len(lens) * (k_ == kernel) for k_ in mma_after}


def _bwd_inputs(cuda, B, H, Hkv, Sq, Sk, D, dtype, seed=5):
    g = torch.Generator(cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt) for s in
               [(B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)])
    do = torch.randn(B, H, Sq, D, generator=g, device=cuda).to(dt)
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,window", BWD_CASES)
def test_flash_bwd_matches_plain_on_card(cuda, B, H, Hkv, Sq, Sk, causal,
                                         window, D, dtype):
    """K1's forward with its log-sum-exp, then the backward kernel, against
    the plain backward from the same output and lse; the lse against the
    plain forward's; autograd through ``flash_attention`` takes both."""
    q, k, v, do = _bwd_inputs(cuda, B, H, Hkv, Sq, Sk, D, dtype)
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal,
                                       window=window)
    torch.testing.assert_close(
        lse, attention_lse_reference(q, k, causal=causal, window=window),
        atol=BWD_TOL["float32"], rtol=BWD_TOL["float32"])
    before = ops.launch_counts()["flash_attention_bwd"]
    paths = dict(fa.flash_attention_bwd.path_launches)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    path = "wgmma" if dtype == "bfloat16" else "fma"
    assert {p: n - paths[p] for p, n in
            fa.flash_attention_bwd.path_launches.items()} == \
        {p: int(p == path) for p in fa.BWD_PATHS}
    exp = attention_backward_reference(q, k, v, out, do, lse, causal=causal,
                                       window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype], msg=name)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*leaves, causal=causal, window=window).backward(do)
    for a, b in zip(leaves, got):
        assert torch.equal(a.grad, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_bitwise_repeatable_on_card(cuda, dtype):
    """No floating-point atomics: two runs of the backward agree bit for
    bit (at a GQA causal shape with several key tiles per CTA), on the
    path of each dtype (wgmma for bf16, fma for fp32)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 333, 333, 64, dtype)
    out, lse = fa.flash_attention_lse(q, k, v)
    ops.reset_counts()
    a = fa.flash_attention_bwd(q, k, v, out, do, lse)
    b = fa.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    path = "wgmma" if dtype == "bfloat16" else "fma"
    assert fa.flash_attention_bwd.path_launches == {
        p: 2 * (p == path) for p in fa.BWD_PATHS}


@pytest.mark.gpu
def test_flash_at_zamba2s_training_shape_on_card(cuda):
    """zamba2-2.7b's shared attention as training calls it: multi-head
    (H = Hkv = 32, G = 1) at head dim 80, S = 4096, causal, bf16 (B cut to
    1 to bound the plain version's memory).  The forward with its lse on
    the mma path, the backward on wgmma, each against its plain version;
    two backward runs equal bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, 1, 32, 32, 4096, 4096, 80, "bfloat16")
    ops.reset_counts()
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), attention_reference(
        q, k, v, causal=True).float(), atol=TOL["bfloat16"],
        rtol=TOL["bfloat16"])
    torch.testing.assert_close(lse, attention_lse_reference(q, k, causal=True),
                               atol=BWD_TOL["float32"],
                               rtol=BWD_TOL["float32"])
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.path_launches == {"fma": 0, "mma": 1,
                                                "split_decode": 0}
    assert fa.flash_attention_bwd.path_launches == {"fma": 0, "wgmma": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exp = attention_backward_reference(q, k, v, out, do, lse, causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=BWD_TOL["bfloat16"],
                                   rtol=BWD_TOL["bfloat16"], msg=name)


@pytest.mark.gpu
def test_flash_bwd_entry_point_refuses_a_path_that_cannot_take_the_call(
        cuda):
    """The wrapper chooses the backward's path; the C entry point returns
    cudaErrorInvalidValue (1) for wgmma on fp32, fma on bf16, a path id
    it does not know and a negative query offset, and launches nothing."""
    ops.build()
    bwd = _build.load()["flash_attention_bwd"].flash_attention_bwd
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fma, wgmma = (fa.BWD_PATHS.index(p) for p in ("fma", "wgmma"))

    def call(path, dtype, q_offset=0):
        q = torch.zeros(1, 4, 64, 64, device=cuda, dtype=dtype)
        kv = torch.zeros(1, 2, 64, 64, device=cuda, dtype=dtype)
        lse, delta = (torch.zeros(1, 4, 64, device=cuda) for _ in range(2))
        grads = [torch.empty_like(t) for t in (q, kv, kv)]
        strides = (ctypes.c_longlong * 24)(*[
            s for t in (q, kv, kv, q, q, *grads) for s in t.stride()[:3]])
        return bwd(q.data_ptr(), kv.data_ptr(), kv.data_ptr(), q.data_ptr(),
                   q.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   *(g.data_ptr() for g in grads), path, fa._DTYPES[dtype],
                   1, 4, 2, 64, 64, 64, strides, 1, 0, q_offset, 0.125,
                   stream)

    f32, bf16 = torch.float32, torch.bfloat16
    assert call(wgmma, f32) == 1                 # wgmma: bf16 only
    assert call(fma, bf16) == 1                  # fma: fp32 only
    assert call(len(fa.BWD_PATHS), bf16) == 1
    assert call(-1, f32) == 1
    assert call(wgmma, bf16, q_offset=-1) == 1
    assert call(wgmma, bf16) == 0                # the paths it would choose
    assert call(fma, f32) == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_bwd_refusals_on_card(cuda):
    """No gradient through kv_len: the backward kernel is for training
    shapes.  A call of decode-sized rows that needs a gradient (a short
    sequence shard) takes the mma path, which writes the lse, and not
    split_decode, which writes none."""
    q, k, v, _ = _bwd_inputs(cuda, 1, 4, 2, 64, 64, 64, "bfloat16")
    q.requires_grad_()
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, causal=False, kv_len=32)
    paths = dict(fa.flash_attention.path_launches)
    out = ops.flash_attention(q[:, :, :1], k, v, causal=False)
    assert fa.flash_attention.path_launches["mma"] == paths["mma"] + 1
    out.sum().backward()
    torch.testing.assert_close(out.float(), attention_reference(
        q[:, :, :1].detach(), k, v, causal=False).float(),
        atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    with torch.no_grad():                        # serving: no lse, no refusal
        ops.flash_attention(q[:, :, :1], k, v, causal=False, kv_len=32)
    assert fa.flash_attention.path_launches["split_decode"] == \
        paths["split_decode"] + 1


def _split_edges(S, nsplit):
    """kv_len values next to every tile edge (and so every split edge)."""
    edges = {1, S}
    for e in range(fa.TILE_K, S + 1, fa.TILE_K):
        edges |= {n for n in (e - 1, e, e + 1) if 1 <= n <= S}
    return sorted(edges)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_flash_decode_at_every_split_edge_on_card(cuda, dtype, as_tensor, B):
    """The serving path's decode shape (B = 16: one split per batch and KV
    head; B = 1: eight, merged by the last to finish): kv_len on both sides
    of every tile and split boundary, read from a strided view of a longer
    (B, S, Hkv, D) cache."""
    g = torch.Generator(cuda).manual_seed(3)
    H, Hkv, S, D = 32, 8, 512, 64
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, H, D, generator=g, device=cuda).to(dt)
    big = [torch.randn(B, S + 64, Hkv, D, generator=g, device=cuda).to(dt)
           for _ in range(2)]
    k, v = (t[:, 32:32 + S] for t in big)          # a view into the buffer
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    nsplit = fa.decode_splits(B * Hkv, S, fa._sm_count(q.device))
    ops.reset_counts()
    edges = _split_edges(S, nsplit)
    for n in edges:
        kv_len = torch.tensor(n, dtype=torch.int32, device=cuda) \
            if as_tensor else n
        out = ops.flash_attention(*args, causal=False, kv_len=kv_len)
        exp = attention_reference(*args, causal=False, kv_len=n)
        torch.testing.assert_close(out.float(), exp.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.flash_attention.path_launches == {
        "fma": 0, "mma": 0, "split_decode": len(edges)}


@pytest.mark.gpu
def test_flash_entry_point_refuses_a_path_that_cannot_take_the_call(cuda):
    """The wrapper chooses the path; the C entry point returns
    cudaErrorInvalidValue (1) for a path whose kernels cannot take the
    call or a negative query offset, and launches nothing."""
    ops.build()
    fwd = _build.load()["flash_attention"].flash_attention_fwd
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fma, mma, split = (fa.PATHS.index(p) for p in ("fma", "mma",
                                                   "split_decode"))

    def call(path, dtype, H, Sq, nsplit=1, lse=None, q_offset=0):
        q = torch.zeros(1, H, Sq, 64, device=cuda, dtype=dtype)
        kv = torch.zeros(1, 1, 64, 64, device=cuda, dtype=dtype)
        out = torch.empty_like(q)
        return fwd(q.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(),
                   None, path, fa._DTYPES[dtype], 1, H, 1, Sq, 64, 64,
                   *q.stride()[:3], *kv.stride()[:3], *kv.stride()[:3],
                   *out.stride()[:3], 64, 1, 0, q_offset, 0.125, None, None,
                   nsplit, lse, stream)

    f32, bf16 = torch.float32, torch.bfloat16
    assert call(mma, f32, 4, 64) == 1            # mma: bf16 only
    assert call(fma, bf16, 4, 64) == 1           # fma: fp32 only
    assert call(split, bf16, 4, 8) == 1          # 32 rows > DECODE_ROWS
    assert call(split, f32, 4, 1) == 1           # fp32 merges: no workspace
    assert call(split, bf16, 4, 1, nsplit=2) == 1
    assert call(split, bf16, 4, 1, nsplit=0) == 1
    assert call(len(fa.PATHS), bf16, 4, 64) == 1
    lse = torch.empty(4 * 64, device=cuda)       # (B, H, Sq) of the mma call
    assert call(split, bf16, 4, 1, lse=lse.data_ptr()) == 1  # no lse here
    assert call(mma, bf16, 4, 64, q_offset=-1) == 1
    assert call(split, bf16, 4, 1) == 0          # the path it would choose
    assert call(mma, bf16, 4, 64, q_offset=32) == 0
    assert call(mma, bf16, 4, 64, lse=lse.data_ptr()) == 0
    assert call(mma, bf16, 4, 64) == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_unsupported_cases_raise_on_card(cuda):
    """A CUDA tensor that no path takes raises; it never reaches the plain
    version."""
    for D, match in ((24, "multiple of 16"), (48, "not in"), (96, "not in")):
        q = torch.zeros(1, 4, 8, D, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            ops.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 8, 72, device=cuda)[..., :64]
    k = torch.zeros(1, 4, 8, 66, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, k, k)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 63, 64, 65, 384, 512])
def test_flash_kernel_decode_kv_len_on_card(cuda, n):
    g = torch.Generator(cuda).manual_seed(1)
    B, H, Hkv, S, D = 16, 32, 8, 512, 64
    q = torch.randn(B, 1, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    kv_len = torch.tensor(n, dtype=torch.int32, device=cuda)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    out = ops.flash_attention(*args, causal=False, kv_len=kv_len)
    exp = attention_reference(*args, causal=False, kv_len=kv_len)
    torch.testing.assert_close(out.float(), exp.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("nblocks,block,width,nout", REPACK_CASES)
def test_repack_kernel_matches_plain_on_card(cuda, nblocks, block, width,
                                             nout):
    src = torch.randn(nblocks, block, width, device=cuda)
    idx = np.random.default_rng(0).integers(0, nblocks, nout)
    out = ops.repack(src, idx)
    assert torch.equal(out, repack_reference(src,
                                             torch.from_numpy(idx).to(cuda)))
    with pytest.raises(IndexError):
        ops.repack(src, [nblocks])


def _ssd_inputs(device, B, H, S, P, N, decay, dtype, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    dt = getattr(torch, dtype)
    xdt = (torch.randn(B, S, H, P, generator=g, device=device) * 0.3).to(dt)
    if decay == "model":
        step = F.softplus(0.64 * torch.randn(B, S, H, generator=g,
                                             device=device))
        a = -step * (1 + 15 * torch.rand(H, generator=g, device=device))
    else:
        a = -torch.randn(B, S, H, generator=g, device=device).abs() * decay
    bm, cm = ((torch.randn(B, S, N, generator=g, device=device) * 0.3).to(dt)
              for _ in range(2))
    return xdt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,P,N,Q,decay,dtype", SSD_CASES)
def test_ssd_kernel_matches_plain_on_card(cuda, B, H, S, P, N, Q, decay,
                                          dtype):
    xdt, a, bm, cm = _ssd_inputs(cuda, B, H, S, P, N, decay, dtype)
    before = ops.launch_counts()["ssd_scan"]
    out = ops.ssd_scan(xdt, a, bm, cm, chunk=Q)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert out.shape == xdt.shape and out.dtype == xdt.dtype
    exp = ssd_reference(xdt, a, bm, cm)
    torch.testing.assert_close(out.float(), exp.float(), atol=SSD_TOL[dtype],
                               rtol=SSD_TOL[dtype])
    chunked = ssd_chunked_reference(xdt, a, bm, cm, Q)
    torch.testing.assert_close(out.float(), chunked.float(),
                               atol=SSD_CHUNKED_TOL[dtype],
                               rtol=SSD_CHUNKED_TOL[dtype])


@pytest.mark.gpu
def test_ssd_kernel_reads_strided_inputs_on_card(cuda):
    """The JAX layout (B, H, S, P) handed over as a transposed view: the
    kernel reads it through strides and gives the contiguous input's y."""
    xdt, a, bm, cm = _ssd_inputs(cuda, 2, 4, 128, 32, 64, 0.02, "float32")
    xt = xdt.transpose(1, 2).contiguous().transpose(1, 2)
    at = a.transpose(1, 2).contiguous().transpose(1, 2)
    assert not xt.is_contiguous() and not at.is_contiguous()
    torch.testing.assert_close(ops.ssd_scan(xt, at, bm, cm, chunk=64),
                               ops.ssd_scan(xdt, a, bm, cm, chunk=64),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.ssd_scan(xdt[..., :24], a, bm, cm, chunk=64)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,Q,nchunks", SSD_WGMMA_CASES)
def test_ssd_wgmma_path_on_card(cuda, P, N, Q, nchunks):
    """bf16 calls the tensor-core path takes: every P, N and Q it has, one
    to four chunks (so the state is carried across 0-3 chunk edges and
    across every 64-row sub-chunk edge), against both plain versions."""
    S = Q * nchunks
    xdt, a, bm, cm = _ssd_inputs(cuda, 2, 3, S, P, N, 0.02, "bfloat16",
                                 seed=P + N + Q)
    assert ss.select_path(torch.bfloat16, P, N, Q) == "wgmma"
    before = dict(ss.ssd_scan.path_launches)
    out = ops.ssd_scan(xdt, a, bm, cm, chunk=Q)
    torch.cuda.synchronize()
    assert {p: ss.ssd_scan.path_launches[p] - before[p] for p in before} \
        == {"fma": 0, "wgmma": 1}
    assert out.shape == xdt.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ssd_reference(
        xdt, a, bm, cm).float(), atol=SSD_TOL["bfloat16"],
        rtol=SSD_TOL["bfloat16"])
    torch.testing.assert_close(out.float(), ssd_chunked_reference(
        xdt, a, bm, cm, Q).float(), atol=SSD_CHUNKED_TOL["bfloat16"],
        rtol=SSD_CHUNKED_TOL["bfloat16"])


@pytest.mark.gpu
def test_ssd_wgmma_path_reads_strided_inputs_on_card(cuda):
    """The wgmma path reads transposed views (B, H, S, P) -> (B, S, H, P)
    and a B/C taken from a wider projection through strides, and gives
    the contiguous inputs' y bit for bit."""
    xdt, a, bm, cm = _ssd_inputs(cuda, 2, 4, 256, 64, 128, 0.02, "bfloat16")
    xt = xdt.transpose(1, 2).contiguous().transpose(1, 2)
    at = a.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.cat([bm, cm, bm], dim=-1)          # (B, S, 3N)
    bw, cw = wide[..., :128], wide[..., 128:256]
    assert not xt.is_contiguous() and not bw.is_contiguous()
    before = ss.ssd_scan.path_launches["wgmma"]
    torch.testing.assert_close(ops.ssd_scan(xt, at, bw, cw, chunk=128),
                               ops.ssd_scan(xdt, a, bm, cm, chunk=128),
                               atol=0, rtol=0)
    assert ss.ssd_scan.path_launches["wgmma"] == before + 2
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(xdt, a, wide[..., 1:129], cm, chunk=128)


@pytest.mark.gpu
def test_ssd_entry_point_refuses_a_path_that_cannot_take_the_call(cuda):
    """The wrapper chooses the path; the C entry point returns
    cudaErrorInvalidValue (1) for a path that cannot take the call, and
    launches nothing."""
    fwd = _build.load()["ssd_scan"].ssd_scan_fwd
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fma, wgmma = ss.PATHS.index("fma"), ss.PATHS.index("wgmma")

    def call(path, dtype, Q=64, P=64, N=128, offset=0):
        x = torch.zeros(1, 128 + 8, 2, P, device=cuda, dtype=dtype)
        a = torch.zeros(1, 128, 2, device=cuda)
        bm = torch.zeros(1, 128, N, device=cuda, dtype=dtype)
        y = torch.empty(1, 128, 2, P, device=cuda, dtype=dtype)
        return fwd(x.data_ptr() + offset * x.element_size(), a.data_ptr(),
                   bm.data_ptr(), bm.data_ptr(), y.data_ptr(), path,
                   ss._DTYPES[dtype], 1, 128, 2, P, N, Q, *x.stride()[:3],
                   *a.stride(), *bm.stride()[:2], *bm.stride()[:2],
                   *y.stride()[:3], stream)

    f32, b16 = torch.float32, torch.bfloat16
    assert call(wgmma, f32) == 1                 # wgmma: bf16 only
    assert call(wgmma, b16, Q=32) == 1           # whole 64-row sub-chunks
    assert call(wgmma, b16, offset=1) == 1       # 16-byte aligned rows
    assert call(fma, b16, P=72) == 1             # P <= 64 on every path
    assert call(len(ss.PATHS), b16) == 1
    assert call(wgmma, b16) == 0                 # the path it would choose
    assert call(fma, f32) == 0
    assert call(fma, b16, Q=32) == 0             # the fma path takes any Q
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("nblocks,block,width,dtype,order,path",
                         REPACK_PATH_CASES)
def test_repack_paths_on_card(cuda, nblocks, block, width, dtype, order,
                              path):
    rng = np.random.default_rng(nblocks)
    src = torch.from_numpy(rng.integers(0, 250, (nblocks, block, width))
                           .astype(np.float32)).to(cuda, getattr(torch, dtype))
    idx = {"perm": rng.permutation(nblocks),
           "many": rng.integers(0, nblocks, 10 * nblocks),
           "repeat": np.array([3, 3, 0, 8, 3, 0]),
           "reverse": np.arange(nblocks)[::-1].copy(),
           "empty": np.zeros(0, dtype=np.int64)}[order]
    before = dict(bc.repack.path_launches)
    out = ops.repack(src, idx)
    torch.cuda.synchronize()
    moved = {p: n - before[p] for p, n in bc.repack.path_launches.items()}
    assert moved == {p: int(p == path and idx.size > 0) for p in moved}
    assert out.shape == (idx.size, block, width) and out.dtype == src.dtype
    assert torch.equal(out, repack_reference(src,
                                             torch.from_numpy(idx).to(cuda)))


@pytest.mark.gpu
def test_repack_back_to_back_with_changing_indices_on_card(cuda):
    """The indices are uploaded asynchronously from pinned memory: calls
    issued back to back, each with new indices and no synchronisation
    between them, must each gather their own blocks."""
    src = torch.randn(64, 16, 256, device=cuda)
    rng = np.random.default_rng(7)
    idxs = [rng.integers(0, 64, 200) for _ in range(40)]
    outs = [ops.repack(src, i) for i in idxs]
    torch.cuda.synchronize()
    for i, out in zip(idxs, outs):
        assert torch.equal(out, src[torch.from_numpy(i).to(cuda)])


@pytest.mark.gpu
def test_decode_path_on_card_matches_cpu(cuda):
    """The smoke model's elastic decode on the card, through the kernel,
    gives the CPU plain path's greedy tokens from the same float32 weights
    (logits agree to ~1e-6, far inside the top-1 margins of this run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import decode_demo
    cfg = get_config("granite-3-2b-smoke")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    run = dict(batch=8, prompt_len=8, decode_steps=8, cache_len=64,
               workers=8, schedule={10: 8, 13: 2}, params=params)
    ref = decode_demo("granite-3-2b-smoke", device="cpu", **run)
    ops.reset_counts()
    out = decode_demo("granite-3-2b-smoke", device=cuda, **run)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers * 16
    assert fa.flash_attention.path_launches["split_decode"] == \
        cfg.num_layers * 16
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert [e.transfer.bytes_moved for e in out["events"]] == \
        [e.transfer.bytes_moved for e in ref["events"]]


@pytest.mark.gpu
def test_mamba2_smoke_on_card_matches_cpu(cuda):
    """The SSM family on the card: the smoke model's prefill runs K3 once
    per layer and its elastic decode gives the CPU plain path's tokens and
    bytes from the same float32 weights."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.train import make_prefill_step
    from repro_torch.serve import decode_demo
    arch = "mamba2-370m-smoke"
    cfg = get_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64), dtype=np.int32))
    prefill = make_prefill_step(cfg)
    with torch.no_grad():
        ref_first = prefill(params, {"tokens": toks})
        ops.reset_counts()
        first = prefill(T.tree_map(lambda t: t.to(cuda), params),
                        {"tokens": toks.to(cuda)})
    assert ops.launch_counts()["ssd_scan"] == cfg.num_layers
    np.testing.assert_array_equal(first.cpu().numpy(), ref_first.numpy())
    run = dict(batch=8, prompt_len=8, decode_steps=8, cache_len=64,
               workers=8, schedule={10: 8, 13: 2}, params=params)
    ref = decode_demo(arch, device="cpu", **run)
    ops.reset_counts()
    out = decode_demo(arch, device=cuda, **run)
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0, "repack": 0,
                                   "ssd_scan": 0, "ssd_scan_bwd": 0}
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert [e.transfer.bytes_moved for e in out["events"]] == \
        [e.transfer.bytes_moved for e in ref["events"]]


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One training step of the smoke model in fp32 on the card (K1 and its
    backward kernel under autograd) gives the CPU plain path's loss and
    gradient norm: fp32 on both, summation orders differ."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.train import init_state, make_train_step
    from repro_torch.optim import AdamW
    cfg = get_config("granite-3-2b-smoke")
    opt = AdamW(learning_rate=1e-3)
    batch = SyntheticDataset(cfg, ShapeConfig("t", "train", 64, 8)
                             ).batch_at(0)
    step = make_train_step(cfg, opt)
    out = {}
    for dev in ("cpu", cuda):
        state = T.tree_map(lambda t: t.to(dev), init_state(cfg, opt, 0))
        ops.reset_counts()
        _, m = step(state, {k: torch.from_numpy(v).to(dev)
                            for k, v in batch.items()})
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         ops.launch_counts())
    (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert n_cpu["flash_attention"] == n_cpu["flash_attention_bwd"] == 0
    assert n_gpu["flash_attention"] == n_gpu["flash_attention_bwd"] == \
        cfg.num_layers
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu)


@pytest.mark.gpu
def test_mamba2_train_step_on_card_matches_cpu(cuda):
    """One mamba2-370m-smoke training step in fp32 on the card, the scan
    forward and backward on K3's kernels under autograd, gives the CPU
    plain path's loss and gradient norm (fp32 on both, summation orders
    differ: the dense family's bounds); with remat, every layer launches
    K3's forward twice and its backward once.  The gradients of the leaves
    that take theirs only through K3's backward (da, dB, dC) each equal
    the CPU's within ``SSM_LEAF_TOL`` of their largest entry."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import train as TT
    from repro_torch.optim import AdamW
    opt = AdamW(learning_rate=1e-3)
    out, leaf = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(get_config("mamba2-370m-smoke"),
                                  remat=remat)
        batch = SyntheticDataset(cfg, ShapeConfig("t", "train", 64, 8)
                                 ).batch_at(0)
        for dev in ("cpu", cuda):
            state = T.tree_map(lambda t: t.to(dev),
                               TT.init_state(cfg, opt, 0))
            tbatch = {k: torch.from_numpy(v).to(dev)
                      for k, v in batch.items()}
            ops.reset_counts()
            _, m = TT.make_train_step(cfg, opt)(state, tbatch)
            out[str(dev), remat] = (float(m["loss"]), float(m["grad_norm"]),
                                    ops.launch_counts())
            state = T.tree_map(lambda t: t.to(dev),
                               TT.init_state(cfg, opt, 0))
            grads = TT._value_and_grad(state.params, cfg, tbatch)[2]
            leaf[str(dev), remat] = {
                k: g.cpu() for (k, _), g in zip(T.flatten(state.params),
                                                grads)
                if k.rsplit("/", 1)[-1] in SSM_SCAN_LEAVES}
    L = get_config("mamba2-370m-smoke").num_layers
    for remat in (False, True):
        (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = \
            out["cpu", remat], out["cuda", remat]
        assert n_cpu["ssd_scan"] == n_cpu["ssd_scan_bwd"] == 0
        assert n_gpu["ssd_scan"] == (2 * L if remat else L)
        assert n_gpu["ssd_scan_bwd"] == L
        assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
        assert abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu)
        assert len(leaf["cpu", remat]) == len(SSM_SCAN_LEAVES)
        for k, exp in leaf["cpu", remat].items():
            assert _rel_err(leaf["cuda", remat][k], exp) <= SSM_LEAF_TOL, k


@pytest.mark.gpu
def test_zamba2_smoke_on_card_matches_cpu(cuda):
    """The hybrid family on the card: the smoke model's prefill runs K3 once
    per layer and K1 once per group; its elastic decode (K1 on
    split_decode once per group and step, no K3) gives the CPU plain
    path's tokens and bytes from the same float32 weights."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.train import make_prefill_step
    from repro_torch.serve import decode_demo
    arch = "zamba2-2.7b-smoke"
    cfg = get_config(arch)
    groups = cfg.num_layers // cfg.shared_attention_every
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64), dtype=np.int32))
    prefill = make_prefill_step(cfg)
    with torch.no_grad():
        ref_first = prefill(params, {"tokens": toks})
        ops.reset_counts()
        first = prefill(T.tree_map(lambda t: t.to(cuda), params),
                        {"tokens": toks.to(cuda)})
    counts = ops.launch_counts()
    assert (counts["ssd_scan"], counts["flash_attention"]) == \
        (cfg.num_layers, groups)
    np.testing.assert_array_equal(first.cpu().numpy(), ref_first.numpy())
    run = dict(batch=8, prompt_len=8, decode_steps=8, cache_len=64,
               workers=8, schedule={10: 8, 13: 2}, params=params)
    ref = decode_demo(arch, device="cpu", **run)
    ops.reset_counts()
    out = decode_demo(arch, device=cuda, **run)
    assert ops.launch_counts()["ssd_scan"] == 0
    assert fa.flash_attention.path_launches == {
        "fma": 0, "mma": 0, "split_decode": groups * 16}
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert [e.transfer.bytes_moved for e in out["events"]] == \
        [e.transfer.bytes_moved for e in ref["events"]]


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_zamba2_train_step_on_card_matches_cpu(cuda, remat):
    """One zamba2-2.7b-smoke training step at two groups (4 layers) in fp32
    on the card: K3's and K1's forward and backward kernels under autograd
    give the CPU plain path's loss and gradient norm (the dense family's
    bounds) and every leaf's gradient, ``shared_attn`` (summed over the
    groups) among them, within ``SSM_LEAF_TOL`` of its largest entry.
    With remat every SSM layer and every shared-block application launches
    its forward twice."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import train as TT
    from repro_torch.optim import AdamW
    opt = AdamW(learning_rate=1e-3)
    cfg = dataclasses.replace(get_config("zamba2-2.7b-smoke"), num_layers=4,
                              remat=remat)
    L, groups = cfg.num_layers, cfg.num_layers // cfg.shared_attention_every
    batch = SyntheticDataset(cfg, ShapeConfig("t", "train", 64, 8)
                             ).batch_at(0)
    out, grads = {}, {}
    for dev in ("cpu", cuda):
        tbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        ops.reset_counts()
        _, m = TT.make_train_step(cfg, opt)(state, tbatch)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         ops.launch_counts())
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        grads[str(dev)] = {k: g.cpu() for (k, _), g in zip(
            T.flatten(state.params),
            TT._value_and_grad(state.params, cfg, tbatch)[2])}
    (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert sum(n_cpu.values()) == 0
    twice = 2 if remat else 1
    assert {k: n_gpu[k] for k in ("ssd_scan", "ssd_scan_bwd",
                                  "flash_attention", "flash_attention_bwd")} \
        == {"ssd_scan": twice * L, "ssd_scan_bwd": L,
            "flash_attention": twice * groups, "flash_attention_bwd": groups}
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(g_gpu - g_cpu) <= 1e-4 * abs(g_cpu)
    assert sum(k.startswith("shared_attn/") for k in grads["cpu"]) == 9
    for k, exp in grads["cpu"].items():
        assert _rel_err(grads["cuda"][k], exp) <= SSM_LEAF_TOL, k


# -- K3's backward -----------------------------------------------------------

SSD_BWD_CASES = [
    # (B, H, S, P, N, Q, decay, dtype): tests/test_kernels.py's SSD cases,
    # the smoke config's scan, a chunk that is not a multiple of the
    # kernel's 64-row tile (Q=48, and Q=100: a ragged second tile), the
    # serving path's P, N, Q with a state alive across chunks, and
    # mamba2's decays (in-chunk cumsums reach ~-3e3)
    (2, 4, 256, 32, 16, 64, 0.4, "float32"),
    (1, 2, 128, 64, 128, 32, 0.4, "float32"),
    (1, 2, 128, 32, 16, 128, 0.4, "float32"),
    (2, 2, 64, 16, 16, 16, 0.4, "bfloat16"),
    (2, 8, 64, 16, 16, 32, 0.4, "float32"),
    (2, 8, 64, 16, 16, 32, 0.4, "bfloat16"),
    (2, 3, 144, 48, 32, 48, 0.02, "float32"),
    (2, 3, 300, 32, 64, 100, 0.02, "bfloat16"),
    (2, 4, 768, 64, 128, 256, 0.02, "bfloat16"),
    (1, 32, 512, 64, 128, 256, "model", "float32"),
    (1, 32, 512, 64, 128, 256, "model", "bfloat16"),
    # the wgmma path at its other shapes: one chunk of one tile; N padded
    # to 64, one tile a chunk; P = N = 16, two tiles; three tiles (an odd
    # count), P and N not powers of two, at mamba2's decays
    (2, 8, 64, 16, 16, 64, 0.4, "bfloat16"),
    (2, 3, 256, 32, 64, 64, 0.02, "bfloat16"),
    (2, 2, 384, 16, 16, 128, 0.4, "bfloat16"),
    (1, 5, 576, 48, 96, 192, "model", "bfloat16"),
    # zamba2-2.7b's scan: 80 heads of P = 64 at N = 64, both dtypes, and
    # its training length (16 chunks of carried state)
    (1, 80, 1024, 64, 64, 256, "model", "float32"),
    (1, 80, 1024, 64, 64, 256, 0.02, "bfloat16"),
    (1, 80, 4096, 64, 64, 256, "model", "bfloat16"),
]
#: each case with the path its dtype and shapes select
SSD_BWD_PATH_CASES = [(*c, ss.select_bwd_path(getattr(torch, c[7]), c[3],
                                              c[4], c[5]))
                      for c in SSD_BWD_CASES]
#: the backward against its plain version, max |kernel - plain| over max
#: |plain| per output: in fp32 both sum in fp32 in other orders (cumsum
#: included), the plain version up to 5.2e-5 from the fp64 gradient in da
#: at mamba2's decays (tests/test_torch_ssm_train.py), so 1e-4, the bound
#: the plain version itself keeps to fp64; bf16 outputs are
#: rounded once (one bf16 step, 2^-7 relative at most), so 1e-2, which
#: the wgmma path's operand roundings keep to 0.34 of at worst at the
#: training shape (kernels/ssd_rounding.py, model_grads); da is fp32 for
#: both dtypes and keeps 1e-4
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
#: the leaves whose gradient comes only through K3's backward, card
#: against CPU in fp32, relative to the leaf's largest entry (chip_smoke.py's
#: SSM_LEAF_TOL; on the CPU the plain backward's formulas in place of
#: autograd move them by up to 3.1e-6)
SSM_SCAN_LEAVES = ("A_log", "dt_bias", "w_dt", "w_B", "w_C", "conv_B",
                   "conv_C")
SSM_LEAF_TOL = 1e-4


def _rel_err(got, ref) -> float:
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert bool(torch.isfinite(got).all())
    return ((got.float() - ref.float()).abs().max() /
            ref.float().abs().max()).item()


def _ssd_bwd_inputs(device, B, H, S, P, N, decay, dtype, seed=0):
    xdt, a, bm, cm = _ssd_inputs(device, B, H, S, P, N, decay, dtype,
                                 seed=seed)
    g = torch.Generator(device).manual_seed(seed + 1)
    dy = torch.randn(B, S, H, P, generator=g, device=device).to(xdt.dtype)
    return xdt, a, bm, cm, dy


def _hold_bwd(got, exp, dtype):
    for name, g_, e_ in zip(("dx", "da", "dB", "dC"), got, exp):
        tol = SSD_BWD_TOL["float32" if name == "da" else dtype]
        assert _rel_err(g_, e_) <= tol, name


def _bwd_moved(before):
    return {p: n - before[p] for p, n in ss.ssd_scan_bwd.path_launches.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,P,N,Q,decay,dtype,path", SSD_BWD_PATH_CASES)
def test_ssd_bwd_kernel_matches_plain_on_card(cuda, B, H, S, P, N, Q, decay,
                                              dtype, path):
    """Each case on the path its dtype and shapes select (bf16 with whole
    64-row tiles, up to four a chunk: wgmma; else fma), one launch."""
    args = _ssd_bwd_inputs(cuda, B, H, S, P, N, decay, dtype)
    before = ops.launch_counts()["ssd_scan_bwd"]
    paths = dict(ss.ssd_scan_bwd.path_launches)
    got = ops.ssd_scan_bwd(*args, chunk=Q)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan_bwd"] == before + 1
    assert _bwd_moved(paths) == {p: int(p == path) for p in ss.BWD_PATHS}
    _hold_bwd(got, ssd_chunked_backward_reference(*args, Q), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_through_autograd_on_card(cuda, dtype):
    """``ops.ssd_scan`` with inputs that need a gradient goes through
    ``SSDScanFn``: the forward on its path, the backward kernel once, and
    the gradients of the direct call."""
    xdt, a, bm, cm, dy = _ssd_bwd_inputs(cuda, 2, 4, 512, 64, 128, "model",
                                         dtype)
    leaves = [t.clone().requires_grad_() for t in (xdt, a, bm, cm)]
    ops.reset_counts()
    y = ops.ssd_scan(*leaves, chunk=256)
    assert y.grad_fn is not None
    torch.testing.assert_close(y.detach(), ops.ssd_scan(xdt, a, bm, cm,
                                                        chunk=256),
                               atol=0, rtol=0)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    path = ss.select_path(getattr(torch, dtype), 64, 128, 256)
    assert ss.ssd_scan.path_launches[path] == 2
    assert ops.launch_counts()["ssd_scan_bwd"] == 1
    assert ss.ssd_scan_bwd.path_launches[
        ss.select_bwd_path(getattr(torch, dtype), 64, 128, 256)] == 1
    for g_, e_ in zip(got, ops.ssd_scan_bwd(xdt, a, bm, cm, dy, chunk=256)):
        torch.testing.assert_close(g_, e_, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,path", [("float32", "fma"),
                                        ("bfloat16", "wgmma")])
def test_ssd_bwd_reads_strided_inputs_on_card(cuda, dtype, path):
    """Transposed views of xdt, a and dy, B and C cut from a wider
    projection, and a dy whose last dim is not contiguous (copied by the
    wrapper): the contiguous inputs' gradients bit for bit, on the path
    the dtype selects."""
    assert ss.select_bwd_path(getattr(torch, dtype), 64, 128, 128) == path
    xdt, a, bm, cm, dy = _ssd_bwd_inputs(cuda, 2, 4, 256, 64, 128, 0.02,
                                         dtype)
    before = dict(ss.ssd_scan_bwd.path_launches)
    xt, at, dyt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (xdt, a, dy))
    wide = torch.cat([bm, cm, bm], dim=-1)
    bw, cw = wide[..., :128], wide[..., 128:256]
    dyf = dy.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not xt.is_contiguous() and not bw.is_contiguous()
    assert dyf.stride(-1) != 1
    exp = ops.ssd_scan_bwd(xdt, a, bm, cm, dy, chunk=128)
    for args in ((xt, at, bw, cw, dyt), (xdt, a, bm, cm, dyf)):
        for g_, e_ in zip(ops.ssd_scan_bwd(*args, chunk=128), exp):
            torch.testing.assert_close(g_, e_, atol=0, rtol=0)
    assert _bwd_moved(before) == {p: 3 * (p == path) for p in ss.BWD_PATHS}
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan_bwd(xdt.transpose(-1, -2).contiguous().transpose(-1, -2),
                         a, bm, cm, dy, chunk=128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,path", [("float32", "fma"),
                                        ("bfloat16", "wgmma")])
def test_ssd_bwd_is_bitwise_repeatable_on_card(cuda, dtype, path):
    """dB and dC sum the heads in a fixed order (no atomics): two runs on
    the same inputs are equal bit for bit, on the path the dtype
    selects."""
    assert ss.select_bwd_path(getattr(torch, dtype), 64, 128, 256) == path
    args = _ssd_bwd_inputs(cuda, 2, 32, 1024, 64, 128, "model", dtype)
    before = dict(ss.ssd_scan_bwd.path_launches)
    first = ops.ssd_scan_bwd(*args, chunk=256)
    second = ops.ssd_scan_bwd(*args, chunk=256)
    torch.cuda.synchronize()
    assert _bwd_moved(before) == {p: 2 * (p == path) for p in ss.BWD_PATHS}
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
def test_bwd_workspace_at_the_training_shape(cuda):
    """The kernel's fp32 scratch at mamba2-370m's training shape (B=8,
    S=4096, H=32, P=64, N=128, Q=256), as its source lays it out.  fma: dB
    and dC per head (2 x 0.54 GB), the chunk states and their gradients
    (2 x 0.13 GB), C B^T, cum and the dcum parts: ~1.4 GB.  wgmma: no
    per-head dB or dC, the states as bf16 hi + lo (2 x 0.13 GB), M^T (34
    MB), cum and dcum's seven parts: ~0.34 GB.  In whole multiples of 4
    floats."""
    n = ss.bwd_workspace_floats(8, 4096, 32, 64, 128, 256, "fma")
    assert 1.3e9 < 4 * n < 1.5e9
    n = ss.bwd_workspace_floats(8, 4096, 32, 64, 128, 256, "wgmma")
    assert 0.3e9 < 4 * n < 0.4e9
    for path in ss.BWD_PATHS:
        assert ss.bwd_workspace_floats(1, 6, 1, 16, 16, 3, path) % 4 == 0
        assert ss.bwd_workspace_floats(1, 64, 1, 16, 16, 0, path) == 0


@pytest.mark.gpu
def test_ssd_bwd_entry_point_refuses_what_it_cannot_take(cuda):
    """The C entry point returns cudaErrorInvalidValue (1), launching
    nothing, for a short workspace, shapes past its limits, an unknown
    path, or a wgmma call the path cannot take: fp32, P or N not multiples
    of 16, a chunk that is not whole 64-row tiles or more than four, rows
    that are not 16-byte aligned."""
    bwd = _build.load()["ssd_scan_bwd"].ssd_scan_bwd
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fma, wgmma = (ss.BWD_PATHS.index(p) for p in ("fma", "wgmma"))

    def call(P=64, N=128, Q=64, S=128, short=0, path=fma, dtype=0,
             shift=0):
        dt = torch.bfloat16 if dtype else torch.float32
        x = torch.zeros(1, S, 2, P + 8, device=cuda, dtype=dt)[..., shift:]
        x = x[..., :P]
        a = torch.zeros(1, S, 2, device=cuda)
        bm = torch.zeros(1, S, N, device=cuda, dtype=dt)
        name = ss.BWD_PATHS[min(path, 1)]
        n = ss.bwd_workspace_floats(1, S, 2, P, N, Q, name) - short \
            if Q else 0
        ws = torch.empty(max(n, 1), device=cuda)
        return bwd(x.data_ptr(), a.data_ptr(), bm.data_ptr(), bm.data_ptr(),
                   x.data_ptr(), x.data_ptr(), a.data_ptr(), bm.data_ptr(),
                   bm.data_ptr(), ws.data_ptr(), n, path, dtype, 1, S, 2, P,
                   N, Q, *x.stride()[:3], *a.stride(), *bm.stride()[:2],
                   *bm.stride()[:2], *x.stride()[:3], stream)

    for path, dtype in ((fma, 0), (fma, 1), (wgmma, 1)):
        assert call(short=4, path=path, dtype=dtype) == 1
        assert call(P=72, path=path, dtype=dtype) == 1
        assert call(P=40, path=path, dtype=dtype) == 1   # P % 16 != 0
        assert call(N=144, path=path, dtype=dtype) == 1
        assert call(N=24, path=path, dtype=dtype) == 1   # N % 16 != 0
        assert call(Q=48, path=path, dtype=dtype) == 1   # S % Q != 0
        assert call(Q=0, path=path, dtype=dtype) == 1
        assert call(path=path, dtype=dtype) == 0
    assert call(path=wgmma, dtype=0) == 1                # fp32
    assert call(Q=32, path=wgmma, dtype=1) == 1          # not whole tiles
    assert call(Q=512, S=512, path=wgmma, dtype=1) == 1  # five tiles or more
    assert call(Q=512, S=512, path=fma, dtype=1) == 0
    assert call(path=wgmma, dtype=1, shift=4) == 1       # 8-byte aligned rows
    assert call(path=len(ss.BWD_PATHS), dtype=1) == 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["Cluster", "ReferenceCluster"])
def test_live_cluster_grid_on_card_equals_cpu(cuda, engine):
    """The paper's live grid (``chip_smoke.py`` phase 14: the ``steady``
    workload of six ten-step jobs on eight workers, static/rigid, then
    ``algorithm2`` and ``throughput-greedy`` rigid and moldable, then a
    cosim replay), sanitized, on workers on the card and on the CPU: equal
    summaries (but ``wall_s``), records, resize events and trails, and
    bit-equal final tenant states (``x``, ``i``) that took every step;
    every tenant's state lived on its workers' device."""
    from repro_torch import dmr
    from repro_torch.parallel.mesh import logical_workers
    from repro_torch.rms import materialize_live

    grid = [("algorithm2", "rigid", False, "policy"),
            ("algorithm2", "rigid", True, "policy"),
            ("algorithm2", "moldable", True, "policy"),
            ("throughput-greedy", "rigid", True, "policy"),
            ("throughput-greedy", "moldable", True, "policy"),
            ("algorithm2", "moldable", True, "cosim")]
    devices_seen = set()

    def factory_into(finals):
        def factory(spec):
            app = dmr.default_app_factory(spec)

            def init(mesh):
                state = app.init_state(mesh)
                devices_seen.add(state["x"].device.type)
                return state

            def step(mesh):
                f = app.make_step(mesh)

                def g(state, i, *a):
                    state, metrics = f(state, i, *a)
                    finals[spec.jid] = state
                    return state, metrics
                return g
            return dmr.App(init=init, shardings=app.state_shardings,
                           step=step, name=app.name)
        return factory

    def run(device, policy, mode, malleable, decisions):
        specs = materialize_live("steady", n_jobs=6, max_steps=10,
                                 device_count=4, mode=mode,
                                 malleable=malleable, seed=0,
                                 arrival_span=10)
        finals = {}
        cl = getattr(dmr, engine)(specs, logical_workers(8, device),
                                  policy=policy, decisions=decisions,
                                  app_factory=factory_into(finals),
                                  sanitize=True)
        res = cl.run()
        s = res.summary()
        s.pop("wall_s")
        if decisions == "cosim":
            cl.crosscheck(res)
        assert {j: int(st["i"]) for j, st in finals.items()} == \
            {sp.jid: sp.steps for sp in specs}
        states = {j: st["x"].cpu() for j, st in finals.items()}
        return (s, [(r.jid, r.start_tick, r.end_tick, r.start_procs,
                     r.final_procs, tuple(r.resizes)) for r in res.records],
                {j: [(e.step, e.action, e.from_procs, e.to_procs,
                      e.transfer.bytes_moved) for e in ev]
                 for j, ev in res.events_by_jid.items()},
                cl.trail), states

    base = None
    for cfg in grid:
        (card, card_x), (cpu, cpu_x) = run("cuda", *cfg), run("cpu", *cfg)
        assert card == cpu, cfg
        assert card_x.keys() == cpu_x.keys(), cfg
        for j in card_x:
            assert torch.equal(card_x[j], cpu_x[j]), (cfg, j)
        if base is None:
            base = card[0]["throughput_jps"]
        else:
            assert card[0]["throughput_jps"] > base, cfg
    assert devices_seen == {"cuda", "cpu"}


# -- the MoE family: K1 at G = 4 (mixtral) and G = 16 (qwen3-moe) -----------

#: (kernel, G, dtype) -> (B, Hkv, Sq, Sk, causal): each path and mma kernel
#: at head dim 128 with mixtral's G = 4 and qwen3-moe's G = 16 (split
#: decode's 16 rows, all of them); the group kernel needs 2 B Hkv >= the
#: SMs, so G = 16 takes it at B = 17, Hkv = 4 (qwen3-moe's own B = 16 takes
#: the block kernel)
MOE_K1 = {("split_decode", 4): (16, 8, 1, 512, False),
          ("split_decode", 16): (16, 4, 1, 512, False),
          ("group", 4): (16, 8, 256, 256, True),
          ("group", 16): (17, 4, 256, 256, True),
          ("block", 4): (2, 2, 300, 300, True),
          ("block", 16): (16, 4, 256, 256, True),
          ("fma", 4): (2, 2, 130, 130, True),
          ("fma", 16): (1, 2, 130, 130, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dtype", [("split_decode", "bfloat16"),
                                          ("split_decode", "float32"),
                                          ("group", "bfloat16"),
                                          ("block", "bfloat16"),
                                          ("fma", "float32")])
@pytest.mark.parametrize("G", [4, 16])
def test_flash_moe_gqa_at_head_dim_128_on_card(cuda, G, kernel, dtype):
    """K1 at mixtral's and qwen3-moe's GQA ratios, D = 128, against the
    plain version on every path: decode over a 512-slot cache at kv_lens
    around tile edges; prefill causal, and with mixtral's window (4096,
    past the sequence: the output equals the causal call's bit for bit)
    and a window that bites (100 keys)."""
    B, Hkv, Sq, Sk, causal = MOE_K1[kernel, G]
    D, H, dt = 128, G * Hkv, getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(G)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
            for _ in range(2))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if kernel == "split_decode":
        calls = [dict(causal=False, kv_len=torch.tensor(
            n, dtype=torch.int32, device=cuda))
            for n in (1, 63, 64, 65, 255, 384, 512)]
    else:
        calls = [dict(causal=True), dict(causal=True, window=4096),
                 dict(causal=True, window=100)]
    path = {"split_decode": "split_decode", "fma": "fma"}.get(kernel, "mma")
    assert _expect(B, H, Hkv, Sq, dtype) == path
    before = dict(fa.flash_attention.path_launches)
    mma_before = fa.mma_kernel_launches()
    outs = []
    for kw in calls:
        outs.append(ops.flash_attention(*args, **kw))
        torch.testing.assert_close(
            outs[-1].float(), attention_reference(*args, **kw).float(),
            atol=TOL[dtype], rtol=TOL[dtype], msg=str(kw))
    if kernel != "split_decode":
        assert torch.equal(outs[0], outs[1])
    after = fa.flash_attention.path_launches
    assert {p: after[p] - before[p] for p in after} == \
        {p: len(calls) * (p == path) for p in after}
    mma_after = fa.mma_kernel_launches()        # as the C entry counts them
    assert {k_: mma_after[k_] - mma_before[k_] for k_ in mma_after} == \
        {k_: len(calls) * (k_ == kernel) for k_ in mma_after}


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [4, 16])
def test_flash_bwd_moe_gqa_on_card(cuda, G, dtype, window):
    """K1's backward at G = 4 and 16, D = 128 (dK and dV summed over 4 and
    16 query heads), causal and windowed, on its dtype's path, against the
    plain backward from the same output and lse."""
    q, k, v, do = _bwd_inputs(cuda, 1, 2 * G, 2, 300, 300, 128, dtype)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True, window=window)
    paths = dict(fa.flash_attention_bwd.path_launches)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                 window=window)
    torch.cuda.synchronize()
    path = "wgmma" if dtype == "bfloat16" else "fma"
    assert {p: n - paths[p] for p, n in
            fa.flash_attention_bwd.path_launches.items()} == \
        {p: int(p == path) for p in fa.BWD_PATHS}
    exp = attention_backward_reference(q, k, v, out, do, lse, causal=True,
                                       window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        torch.testing.assert_close(a.float(), b.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype], msg=name)


@pytest.mark.gpu
def test_flash_at_mixtrals_training_shape_on_card(cuda):
    """mixtral-8x7b's attention as training calls it: 32 query heads over 8
    KV heads (G = 4) at head dim 128, S = 4096, causal with its window of
    4096, bf16 (B cut to 1 to bound the plain version's memory).  Forward
    with its lse on mma, backward on wgmma, each against its plain
    version; two backward runs equal bit for bit; at S <= window the
    window changes no bit of the output, the lse or the gradients."""
    q, k, v, do = _bwd_inputs(cuda, 1, 32, 8, 4096, 4096, 128, "bfloat16")
    ops.reset_counts()
    out, lse = fa.flash_attention_lse(q, k, v, causal=True, window=4096)
    torch.testing.assert_close(out.float(), attention_reference(
        q, k, v, causal=True).float(), atol=TOL["bfloat16"],
        rtol=TOL["bfloat16"])
    torch.testing.assert_close(lse, attention_lse_reference(q, k, causal=True),
                               atol=BWD_TOL["float32"],
                               rtol=BWD_TOL["float32"])
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                 window=4096)
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                   window=4096)
    out0, lse0 = fa.flash_attention_lse(q, k, v, causal=True)
    plain = fa.flash_attention_bwd(q, k, v, out0, do, lse0, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.path_launches == {"fma": 0, "mma": 2,
                                                "split_decode": 0}
    assert fa.flash_attention_bwd.path_launches == {"fma": 0, "wgmma": 3}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(out, out0) and torch.equal(lse, lse0)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    exp = attention_backward_reference(q, k, v, out, do, lse, causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=BWD_TOL["bfloat16"],
                                   rtol=BWD_TOL["bfloat16"], msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_layer_on_card_matches_cpu(cuda, cf):
    """mixtral-smoke's MoE layer (no kernel of its own: plain PyTorch, as
    the JAX package's jnp) in fp32 on the card against the CPU: the same
    kept slots, output, aux loss and gradients of x and every leaf, at the
    config's capacity and at one that drops."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE
    from repro_torch.models.params import init
    cfg = get_config("mixtral-8x7b-smoke")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    params = init(MoE.moe_schema(cfg), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16, cfg.d_model, generator=g)
    w = torch.randn(4, 16, cfg.d_model, generator=g)
    res = {}
    for dev in ("cpu", cuda):
        p = {k_: t.to(dev).detach().requires_grad_()
             for k_, t in params.items()}
        xd = x.to(dev).detach().requires_grad_()
        with MoE.count_drops() as drops:
            y, aux = MoE.moe_apply(p, xd, cfg)
        ((y * w.to(dev)).sum() + aux).backward()
        res[str(dev)] = (y.detach().cpu(), float(aux), xd.grad.cpu(),
                         {k_: t.grad.cpu() for k_, t in p.items()},
                         dict(drops))
    (yc, ac, gxc, gc, dc), (yg, ag, gxg, gg, dg) = res["cpu"], res["cuda"]
    assert dc == dg and (dc["dropped"] > 0) == (cf < 1.0)
    torch.testing.assert_close(yg, yc, atol=1e-5, rtol=1e-5)
    assert abs(ag - ac) <= 1e-6 * abs(ac)
    torch.testing.assert_close(gxg, gxc, atol=1e-6, rtol=1e-4)
    for k_ in gc:
        assert _rel_err(gg[k_], gc[k_]) <= 1e-5, k_


@pytest.mark.gpu
def test_mixtral_train_step_on_card_matches_cpu(cuda):
    """One mixtral-8x7b-smoke training step in fp32 on the card (K1 on the
    fma path with its window of 16 over 64 tokens, its backward on fma,
    the MoE layer in plain PyTorch) gives the CPU's loss, ce_loss,
    aux_loss and gradient norm, and every leaf's gradient within 1e-4 of
    its largest entry."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import train as TT
    from repro_torch.optim import AdamW
    cfg = get_config("mixtral-8x7b-smoke")
    opt = AdamW(learning_rate=1e-3)
    batch = SyntheticDataset(cfg, ShapeConfig("t", "train", 64, 8)
                             ).batch_at(0)
    out, grads = {}, {}
    for dev in ("cpu", cuda):
        tbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        ops.reset_counts()
        _, m = TT.make_train_step(cfg, opt)(state, tbatch)
        out[str(dev)] = ({k: float(m[k]) for k in ("loss", "ce_loss",
                                                   "aux_loss", "grad_norm")},
                         ops.launch_counts(),
                         dict(fa.flash_attention.path_launches),
                         dict(fa.flash_attention_bwd.path_launches))
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        g_ = TT._value_and_grad(state.params, cfg, tbatch)[2]
        grads[str(dev)] = {k: t.cpu() for (k, _), t in
                           zip(T.flatten(state.params), g_)}
    (mc, nc, _, _), (mg, ng, pg, pbg) = out["cpu"], out["cuda"]
    L = cfg.num_layers
    assert nc["flash_attention"] == nc["flash_attention_bwd"] == 0
    assert ng["flash_attention"] == ng["flash_attention_bwd"] == L
    assert pg == {"fma": L, "mma": 0, "split_decode": 0}
    assert pbg == {"fma": L, "wgmma": 0}
    for k in ("loss", "ce_loss", "aux_loss"):
        assert abs(mg[k] - mc[k]) <= 1e-5 * abs(mc[k]), k
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]
    assert any("/moe/" in k for k in grads["cpu"])
    for k, exp in grads["cpu"].items():
        assert _rel_err(grads["cuda"][k], exp) <= 1e-4, k


# -- the encoder-decoder and vision-prefix families ------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Sk", [512, 300])
def test_flash_cross_decode_on_card(cuda, Sk, dtype):
    """A decode step's cross-attention: one query row per head (G = 1, D =
    64, seamless-m4t's heads) against a cross cache whose every slot is
    valid, no ``kv_len`` and no mask, on split_decode, read in the cache's
    (B, S, Hkv, D) layout."""
    g = torch.Generator(cuda).manual_seed(11)
    dt = getattr(torch, dtype)
    q = torch.randn(16, 1, 16, 64, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(16, Sk, 16, 64, generator=g, device=cuda).to(dt)
            for _ in range(2))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = dict(fa.flash_attention.path_launches)
    masks = dict(fa.flash_attention.mask_launches)
    out = ops.flash_attention(*args, causal=False)
    torch.cuda.synchronize()
    after = fa.flash_attention.path_launches
    assert {p: after[p] - before[p] for p in after} == \
        {p: int(p == "split_decode") for p in after}
    assert {m: n - masks[m] for m, n in
            fa.flash_attention.mask_launches.items()} == \
        {m: int(m == "rect") for m in fa.MASKS}
    torch.testing.assert_close(
        out.float(), attention_reference(*args, causal=False).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-medium-smoke",
                                  "pixtral-12b-smoke"])
def test_zoo_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 training step of the encoder-decoder and the vision-prefix
    smoke models on the card (K1 on the fma path: seamless's encoder
    self-attention, decoder self- and cross-attention; pixtral's causal
    prefix + text; the backward on fma) gives the CPU's loss and gradient
    norm, and every leaf's gradient within 1e-4 of its largest entry.
    Counted by mask, the causal launches are the decoder's self-attention
    and the rest the encoder's and the cross-attention's."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import train as TT
    from repro_torch.optim import AdamW
    cfg = get_config(arch)
    opt = AdamW(learning_rate=1e-3)
    batch = SyntheticDataset(cfg, ShapeConfig("t", "train", 64, 8)
                             ).batch_at(0)
    out, grads = {}, {}
    for dev in ("cpu", cuda):
        tbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        ops.reset_counts()
        _, m = TT.make_train_step(cfg, opt)(state, tbatch)
        out[str(dev)] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                         ops.launch_counts(),
                         dict(fa.flash_attention.path_launches),
                         dict(fa.flash_attention_bwd.path_launches),
                         [dict(f.mask_launches) for f in
                          (fa.flash_attention, fa.flash_attention_bwd)])
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        g_ = TT._value_and_grad(state.params, cfg, tbatch)[2]
        grads[str(dev)] = {k: t.cpu() for (k, _), t in
                           zip(T.flatten(state.params), g_)}
    (mc, nc, _, _, _), (mg, ng, pg, pbg, masks) = out["cpu"], out["cuda"]
    n = cfg.num_layers * (2 if cfg.is_encdec else 1) + cfg.encoder_layers
    for m_ in masks:
        assert m_["causal"] == cfg.num_layers and m_["kv_len"] == 0
        assert m_["square"] + m_["rect"] == n - cfg.num_layers
    assert nc["flash_attention"] == nc["flash_attention_bwd"] == 0
    assert ng["flash_attention"] == ng["flash_attention_bwd"] == n
    assert pg == {"fma": n, "mma": 0, "split_decode": 0}
    assert pbg == {"fma": n, "wgmma": 0}
    assert abs(mg["loss"] - mc["loss"]) <= 1e-5 * abs(mc["loss"])
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]
    assert "frontend_proj" in grads["cpu"]
    for k, exp in grads["cpu"].items():
        assert _rel_err(grads["cuda"][k], exp) <= 1e-4, k


# K1's forward and backward at the dense training configs' GQA ratios
# (phi4-mini G = 3, qwen2.5 G = 5, internlm2 G = 6) and head dim 128, as
# their training steps call it: causal, with the lse, Sq = Sk = 333 (not a
# multiple of 64: a ragged last tile), two KV heads
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", GQA_RATIOS)
def test_flash_dense_training_ratios_on_card(cuda, G, dtype):
    """The forward with its lse and the backward (dK and dV summed over the
    G query heads of each KV head) against their plain versions, each on
    its dtype's path; autograd through ``flash_attention`` takes both."""
    B, Hkv, S, D = 2, 2, 333, 128
    q, k, v, do = _bwd_inputs(cuda, B, G * Hkv, Hkv, S, S, D, dtype,
                              seed=G)
    fwd0 = dict(fa.flash_attention.path_launches)
    bwd0 = dict(fa.flash_attention_bwd.path_launches)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), attention_reference(
        q, k, v, causal=True).float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, attention_lse_reference(q, k),
                               atol=BWD_TOL["float32"],
                               rtol=BWD_TOL["float32"])
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    torch.cuda.synchronize()
    fpath = "fma" if dtype == "float32" else "mma"
    bpath = "fma" if dtype == "float32" else "wgmma"
    assert {p: n - fwd0[p] for p, n in
            fa.flash_attention.path_launches.items()} == \
        {p: int(p == fpath) for p in fa.PATHS}
    assert {p: n - bwd0[p] for p, n in
            fa.flash_attention_bwd.path_launches.items()} == \
        {p: int(p == bpath) for p in fa.BWD_PATHS}
    exp = attention_backward_reference(q, k, v, out, do, lse, causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype], msg=name)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*leaves, causal=True).backward(do)
    for a, b in zip(leaves, got):
        assert torch.equal(a.grad, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_bitwise_repeatable_at_g3_on_card(cuda, dtype):
    """phi4-mini's ratio (G = 3, D = 128, causal, several key tiles per
    CTA): two runs of the backward agree bit for bit."""
    q, k, v, do = _bwd_inputs(cuda, 2, 6, 2, 333, 333, 128, dtype)
    out, lse = fa.flash_attention_lse(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, out, do, lse)
    b = fa.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("name,heads", [
    ("phi4-mini-3.8b", (6, 2)), ("qwen2.5-32b", (10, 2)),
    ("internlm2-20b", (12, 2))])
def test_dense_train_step_on_card_matches_cpu(cuda, name, heads):
    """One fp32 training step of the dense smoke configs at head dim 128
    and their full configs' G and microbatches (qwen2.5's QKV bias among
    the leaves) on the card (K1 and its backward on fma, once a layer and
    microbatch) gives the CPU's loss and gradient norm, and every leaf's
    gradient within 1e-4 of its largest entry."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import train as TT
    from repro_torch.optim import AdamW
    mb = get_config(name).train_microbatches
    cfg = dataclasses.replace(get_config(f"{name}-smoke"), num_heads=heads[0],
                              num_kv_heads=heads[1], head_dim=128,
                              train_microbatches=mb)
    opt = AdamW(learning_rate=1e-3)
    batch = SyntheticDataset(cfg, ShapeConfig("t", "train", 64, 8)
                             ).batch_at(0)
    out, grads = {}, {}
    for dev in ("cpu", cuda):
        tbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        ops.reset_counts()
        _, m = TT.make_train_step(cfg, opt)(state, tbatch)
        out[str(dev)] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                         ops.launch_counts(),
                         dict(fa.flash_attention.path_launches))
        state = T.tree_map(lambda t: t.to(dev), TT.init_state(cfg, opt, 0))
        g_ = TT._value_and_grad(state.params, cfg, tbatch)[2]
        grads[str(dev)] = {k: t.cpu() for (k, _), t in
                           zip(T.flatten(state.params), g_)}
    (mc, nc, _), (mg, ng, pg) = out["cpu"], out["cuda"]
    n = cfg.num_layers * mb
    assert nc["flash_attention"] == nc["flash_attention_bwd"] == 0
    assert ng["flash_attention"] == ng["flash_attention_bwd"] == n
    assert pg == {"fma": n, "mma": 0, "split_decode": 0}
    assert abs(mg["loss"] - mc["loss"]) <= 1e-5 * abs(mc["loss"])
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]
    assert ("layers/attn/bq" in grads["cpu"]) == (name == "qwen2.5-32b")
    for k, exp in grads["cpu"].items():
        assert _rel_err(grads["cuda"][k], exp) <= 1e-4, k


# -- K1 with a causal query offset (sequence-parallel attention) -----------

# (B, H, Hkv, Sq, Sk, q_offset, window, dtype): each path, the mma path's
# block and group kernels (B * Hkv >= 66 on a 132-SM card), ragged shards,
# windows measured from the offset row
OFFSET_CASES = [
    (2, 8, 2, 64, 256, 128, 0, "float32"),           # fma
    (2, 8, 2, 77, 300, 150, 40, "float32"),          # fma, window, ragged
    (1, 8, 2, 64, 256, 192, 0, "bfloat16"),          # mma block
    (2, 8, 2, 100, 300, 160, 64, "bfloat16"),        # mma block, window
    (16, 24, 8, 64, 256, 64, 0, "bfloat16"),         # mma group
    (16, 16, 8, 64, 256, 0, 0, "bfloat16"),          # mma group, offset 0
    (3, 8, 2, 2, 200, 150, 0, "bfloat16"),           # split_decode
    (3, 8, 2, 2, 200, 150, 30, "float32"),           # split_decode, window
]
# (B, H, Hkv, Sq, Sk, q_offset, window): the backward on its dtype's path
OFFSET_BWD_CASES = [
    (2, 4, 2, 64, 256, 128, 0),
    (1, 4, 2, 100, 300, 150, 40),
    (2, 8, 2, 77, 256, 0, 0),
    (1, 6, 2, 64, 128, 64, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,q_offset,window,dtype", OFFSET_CASES)
def test_flash_with_query_offset_on_card(cuda, B, H, Hkv, Sq, Sk, q_offset,
                                         window, dtype, D):
    """K1 with a causal query offset against its plain version, counted
    under the ``offset`` mask on the path ``select_path`` names."""
    q, k, v, _ = _bwd_inputs(cuda, B, H, Hkv, Sq, Sk, D, dtype)
    masks = dict(fa.flash_attention.mask_launches)
    paths = dict(fa.flash_attention.path_launches)
    out = fa.flash_attention(q, k, v, causal=True, window=window,
                             q_offset=q_offset)
    torch.cuda.synchronize()
    path = fa.select_path(q.dtype, H // Hkv * Sq)
    assert {p: n - paths[p] for p, n in
            fa.flash_attention.path_launches.items()} == \
        {p: int(p == path) for p in fa.PATHS}
    assert {m: n - masks[m] for m, n in
            fa.flash_attention.mask_launches.items()} == \
        {m: int(m == "offset") for m in fa.MASKS}
    exp = attention_reference(q, k, v, causal=True, window=window,
                              q_offset=q_offset)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,q_offset,window", OFFSET_BWD_CASES)
def test_flash_bwd_with_query_offset_on_card(cuda, B, H, Hkv, Sq, Sk,
                                             q_offset, window, dtype):
    """K1's forward (with its lse) and backward with a query offset against
    the plain versions; keys past the shard's last position get zero dk
    and dv."""
    q, k, v, do = _bwd_inputs(cuda, B, H, Hkv, Sq, Sk, 128, dtype)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True, window=window,
                                      q_offset=q_offset)
    torch.testing.assert_close(
        lse, attention_lse_reference(q, k, causal=True, window=window,
                                     q_offset=q_offset),
        atol=TOL[dtype], rtol=TOL[dtype])
    masks = dict(fa.flash_attention_bwd.mask_launches)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                 window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.mask_launches["offset"] == \
        masks["offset"] + 1
    exp = attention_backward_reference(q, k, v, out, do, lse, causal=True,
                                       window=window, q_offset=q_offset)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        torch.testing.assert_close(a.float(), b.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype], msg=name)
    last = q_offset + Sq
    if last < Sk:
        assert not got[1][:, :, last:].any() and not got[2][:, :, last:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_offset_shards_tile_the_full_call_on_card(cuda, dtype):
    """Eight query shards of a causal S = 1024 call, each with its offset
    over the whole sequence's keys: their outputs, concatenated, and their
    gradients (dk, dv summed over the shards) against one full call."""
    S, n = 1024, 8
    q, k, v, do = _bwd_inputs(cuda, 2, 12, 4, S, S, 128, dtype)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    full = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    outs, dq, dk, dv = [], [], 0, 0
    for r in range(n):
        sl = slice(r * S // n, (r + 1) * S // n)
        o_r, l_r = fa.flash_attention_lse(q[:, :, sl], k, v, causal=True,
                                          q_offset=sl.start)
        g = fa.flash_attention_bwd(q[:, :, sl], k, v, o_r, do[:, :, sl], l_r,
                                   causal=True, q_offset=sl.start)
        outs.append(o_r)
        dq.append(g[0])
        dk, dv = dk + g[1].float(), dv + g[2].float()
    tol = TOL[dtype]
    torch.testing.assert_close(torch.cat(outs, 2).float(), out.float(),
                               atol=tol, rtol=tol)
    for name, a, b in (("dq", torch.cat(dq, 2), full[0]), ("dk", dk, full[1]),
                       ("dv", dv, full[2])):
        torch.testing.assert_close(a.float(), b.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype], msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n", [("qwen2.5-32b-smoke", 8),
                                    ("qwen3-moe-235b-a22b-smoke", 4),
                                    ("mixtral-8x7b-smoke", 8)])
def test_sharded_smoke_step_on_card_matches_cpu(cuda, arch, n):
    """One ``lm_train_app`` step on a job mesh of ``n`` card workers from
    the CPU's initial state: qwen2.5-smoke's 4 heads on 8 workers take the
    sequence path (K1 once per worker and layer with its offset, forward
    and backward), qwen3-moe-smoke's MoE on 4 routes each shard's tokens
    (EP), mixtral-smoke's on 8 runs TP with F whole.  Loss, aux loss and
    gradient norm equal the CPU workers' within 1e-5 / 1e-4 relative."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.lm_app import lm_train_app
    from repro_torch.optim import AdamW
    from repro_torch.parallel.mesh import logical_workers, make_job_mesh
    cfg = get_config(arch)
    app = lm_train_app(cfg, ShapeConfig("t", "train", 64, 8),
                       AdamW(learning_rate=1e-3), seed=0)
    state0 = app.init_state(make_job_mesh(logical_workers(n, "cpu")))
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_job_mesh(logical_workers(n, dev))
        state = T.tree_map(lambda t: t.to(dev, copy=True), state0)
        ops.reset_counts()
        _, m = app.make_step(mesh)(state, 0)
        out[str(dev)] = ({k: float(m[k]) for k in m if k != "step"},
                         dict(fa.flash_attention.mask_launches),
                         dict(fa.flash_attention_bwd.mask_launches))
    (mc, _, _), (mg, fwd, bwd) = out["cpu"], out["cuda"]
    seq = cfg.num_heads % n != 0
    L = cfg.num_layers
    assert fwd["offset"] == bwd["offset"] == (L * n if seq else 0)
    assert fwd["causal"] == bwd["causal"] == (0 if seq else L)
    for k in ("loss", "ce_loss", "aux_loss"):
        if k in mc:
            assert abs(mg[k] - mc[k]) <= 1e-5 * abs(mc[k]) + 1e-7, k
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]


@pytest.mark.gpu
def test_cg_example_on_card_matches_cpu(cuda):
    """``repro_torch.examples.cg_solver.main()`` on its default device, the
    card: the example's own check passes, its resize events (bytes per
    pattern included) equal the CPU run's exactly, its state lives on the
    card, and x is within 1e-6 of the CPU's (the parity bound of
    ``tests/test_torch_examples.py``)."""
    import contextlib
    import io

    from repro_torch.examples import cg_solver

    def events(runner):
        return [(e.step, e.action, e.from_procs, e.to_procs,
                 e.transfer.bytes_moved,
                 {k: v.bytes_moved for k, v in e.per_pattern.items()})
                for e in runner.events]

    with contextlib.redirect_stdout(io.StringIO()):
        card = cg_solver.main()
        cpu = cg_solver.main(device="cpu")
    assert card[2]["lines"][-1].startswith("OK")
    assert events(card[0]) == events(cpu[0]) and len(card[0].events) == 2
    assert {t.device.type for t in card[1].values()} == {"cuda"}
    torch.testing.assert_close(card[1]["x"].cpu(), cpu[1]["x"], rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [True, False])
def test_donated_resize_holds_one_leaf_on_card(cuda, donate):
    """A donated ``redistribute_tree`` over several leaves raises the
    card's peak allocation by at most its largest leaf (each source goes
    once its copy is made); ``donate=False`` by the whole tree (both
    copies at once).  Values are equal either way."""
    from repro_torch import dmr
    from repro_torch import tree as T

    mib = 2 ** 20
    state = {"a": torch.randn(16 * mib // 4, device=cuda),
             "b": {"c": torch.randn(8 * mib // 4, device=cuda),
                   "d": torch.randn(4 * mib // 2, device=cuda,
                                    dtype=torch.bfloat16)},
             "e": torch.randn(12 * mib // 4, device=cuda)}
    want = [t.cpu() for t in T.leaves(state)]
    leaf_b = max(t.nbytes for t in T.leaves(state))
    tree_b = sum(t.nbytes for t in T.leaves(state))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, tot, _ = dmr.redistribute_tree(
        state, T.tree_map(lambda _: None, state),
        patterns={"b/c": lambda l, s, c: l.clone()}, donate=donate)
    rise = torch.cuda.max_memory_allocated() - before
    slack = 2 * mib                  # the allocator's rounding of a block
    if donate:
        assert rise <= leaf_b + slack
        assert torch.cuda.memory_allocated() - before <= slack
        assert all(t.is_meta for t in T.leaves(state))
    else:
        assert tree_b <= rise <= tree_b + slack
        assert torch.cuda.memory_allocated() - before >= tree_b
    assert tot.bytes_moved == tree_b
    for a, b in zip(T.leaves(out), want):
        assert a.is_cuda and torch.equal(a.cpu(), b)


#: the card's memory bandwidth (NVIDIA's data sheet, H100 SXM)
HBM_BYTES_PER_S = 3.35e12


@pytest.mark.gpu
def test_transfer_seconds_time_the_moves_not_the_queue_on_card(cuda):
    """A 4 -> 8 resize of a 1 GiB leaf issued behind at least 20 ms of
    queued matmuls, with no sync between: its ``transfer.seconds`` counts
    the copy from when the stream reached it, so it stays under the
    queue's time and within 2x of the copy's bandwidth bound (the leaf
    read once and written once)."""
    from repro_torch import dmr
    from repro_torch.parallel.mesh import Placement, logical_workers

    leaf_bytes = 2 ** 30
    app = dmr.App(
        init=lambda mesh: {"w": torch.randn(leaf_bytes // 4, device=cuda)},
        shardings=lambda mesh: {"w": Placement(mesh, 0)},
        step=lambda mesh: (lambda state, i: (state, None)), name="leaf")
    runner = dmr.MalleableRunner(app, dmr.set_parameters(2, 8, 4), {0: 8},
                                 devices=logical_workers(8, cuda))
    state = runner.init()
    a = torch.randn(8192, 8192, device=cuda)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    a @ a
    end.record()
    torch.cuda.synchronize()
    repeats = int(25.0 / start.elapsed_time(end)) + 1
    start.record()
    for _ in range(repeats):
        a @ a
    end.record()
    state = dmr.reconfig(runner, state, 0)
    torch.cuda.synchronize()
    queued_s = start.elapsed_time(end) / 1e3
    (event,) = runner.events
    seconds, bound = event.transfer.seconds, 2 * leaf_bytes / HBM_BYTES_PER_S
    assert (event.from_procs, event.to_procs) == (4, 8)
    assert queued_s >= 0.020
    assert seconds < queued_s
    assert bound / 2 <= seconds <= 2 * bound, (seconds, bound)
