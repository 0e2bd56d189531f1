"""The port's kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it) and the JAX oracle, on the same numpy inputs, at the tolerances of
``tests/test_kernels.py``: 2e-5 for float32 (both sides compute in fp32;
only summation order differs) and 2e-2 for bfloat16 (outputs rounded to
8 mantissa bits).  ``tests/test_torch_gpu.py`` holds the CUDA kernels
against their plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

ATTN_CASES = [
    # (B, H, Hkv, Sq, Sk, D, causal, window, dtype) — tests/test_kernels.py
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 8, 8, 128, 128, 128, False, 0, "float32"),
    (2, 4, 1, 256, 256, 64, True, 64, "float32"),
    (1, 2, 2, 128, 128, 64, True, 0, "bfloat16"),
    (1, 4, 2, 64, 64, 32, True, 0, "float32"),
]

DECODE_CASES = [
    # (B, H, Hkv, Sk, D) — single-token query against a cache
    (3, 4, 2, 128, 64),
    (3, 4, 2, 256, 64),
    (3, 4, 2, 384, 64),
    (5, 8, 1, 256, 64),
    (7, 2, 2, 192, 32),
    (1, 4, 4, 512, 128),
]

REPACK_CASES = [(16, 8, 32, 10), (8, 16, 16, 8), (32, 8, 128, 32)]


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(out, exp, dtype):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _t2np(t):
    return t.float().numpy()


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window,dtype", ATTN_CASES)
def test_attention_matches_jax_kernel(B, H, Hkv, Sq, Sk, D, causal, window,
                                      dtype):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(rng, s), dtype) for s in
                                    [(B, H, Sq, D), (B, Hkv, Sk, D),
                                     (B, Hkv, Sk, D)])
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (B, H, Sq, D) and out.dtype == tq.dtype
    kern = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64)
    oracle = jref.attention_reference(jq, jk, jv, causal=causal,
                                      window=window)
    _close(_t2np(out), kern, dtype)
    _close(_t2np(out), oracle, dtype)


@pytest.mark.parametrize("B,H,Hkv,Sk,D", DECODE_CASES)
def test_decode_attention_matches_jax_kernel(B, H, Hkv, Sk, D):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(rng, s), "float32") for s in
                                    [(B, H, 1, D), (B, Hkv, Sk, D),
                                     (B, Hkv, Sk, D)])
    out = ops.flash_attention(tq, tk, tv, causal=False)
    kern = jops.flash_attention(jq, jk, jv, causal=False, block_q=64,
                                block_k=64)
    _close(_t2np(out), kern, "float32")


def test_decode_consistent_as_cache_grows():
    """A decode step over a prefix cache equals the same row of a causal
    pass, in the port and against the JAX kernel."""
    rng = np.random.default_rng(2)
    B, H, S, D = 2, 4, 256, 64
    (jq, tq), (jk, tk), (jv, tv) = (_both(_np(rng, (B, H, S, D)), "float32")
                                    for _ in range(3))
    full = ops.flash_attention(tq, tk, tv, causal=True)
    jfull = jops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                 block_k=64)
    for pos in (64, 128, 192):
        step = ops.flash_attention(tq[:, :, pos - 1:pos], tk[:, :, :pos],
                                   tv[:, :, :pos], causal=False)
        _close(_t2np(step[:, :, 0]), _t2np(full[:, :, pos - 1]), "float32")
        _close(_t2np(step[:, :, 0]), jfull[:, :, pos - 1], "float32")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_kv_len_equals_a_shorter_cache(as_tensor):
    """``kv_len`` (the decode step's filled prefix) masks the cache tail:
    the result equals the JAX oracle over the first kv_len keys, read from
    the (B, S, Hkv, D) cache layout through strides."""
    rng = np.random.default_rng(3)
    B, H, Hkv, S, D, n = 3, 8, 2, 96, 64, 37
    q, k, v = _np(rng, (B, 1, H, D)), _np(rng, (B, S, Hkv, D)), \
        _np(rng, (B, S, Hkv, D))
    kv_len = torch.tensor(n, dtype=torch.int32) if as_tensor else n
    out = ops.flash_attention(torch.from_numpy(q).transpose(1, 2),
                              torch.from_numpy(k).transpose(1, 2),
                              torch.from_numpy(v).transpose(1, 2),
                              causal=False, kv_len=kv_len)
    exp = jref.attention_reference(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k[:, :n]).transpose(0, 2, 1, 3),
        jnp.asarray(v[:, :n]).transpose(0, 2, 1, 3), causal=False)
    _close(_t2np(out), exp, "float32")


@pytest.mark.parametrize("nblocks,block,width,nout", REPACK_CASES)
def test_repack_matches_jax_kernel(nblocks, block, width, nout):
    rng = np.random.default_rng(4)
    src = _np(rng, (nblocks, block, width))
    idx = rng.permutation(nblocks)[:nout].astype(np.int32)
    out = ops.repack(torch.from_numpy(src), idx)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jops.repack(jnp.asarray(src),
                                            jnp.asarray(idx))))


def test_cpu_calls_are_not_launches():
    ops.reset_counts()
    q = torch.zeros(1, 2, 4, 32)
    ops.flash_attention(q, q, q)
    ops.repack(torch.zeros(4, 2, 3), [3, 0])
    assert ops.launch_counts() == {"flash_attention": 0, "repack": 0}


def test_no_silent_fallback_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; it
    never takes the plain version."""
    q = torch.empty(1, 2, 4, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.repack(torch.empty(4, 2, 3, device="meta"), [0])
