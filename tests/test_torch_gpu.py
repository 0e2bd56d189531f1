"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: each test skips, with a reason, when no CUDA card is
present (decided in a fixture at run time, never at import).  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32 (the
kernel computes in fp32 FMAs, never TF32) and 2e-2 for bfloat16; the
repack is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference, repack_reference

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

REPACK_CASES = [(16, 8, 32, 10), (8, 16, 16, 8), (32, 8, 128, 32), (7, 3, 5, 9)]


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
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert [e.transfer.bytes_moved for e in out["events"]] == \
        [e.transfer.bytes_moved for e in ref["events"]]
