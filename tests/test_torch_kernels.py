"""The port's kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it) and the JAX oracle, on the same numpy inputs, at the tolerances of
``tests/test_kernels.py``: 2e-5 for float32 (both sides compute in fp32;
only summation order differs) and 2e-2 for bfloat16 (outputs rounded to
8 mantissa bits).  ``tests/test_torch_gpu.py`` holds the CUDA kernels
against their plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention
from repro_torch.kernels import blockcyclic as bc
from repro_torch.kernels import bwd_rounding
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

ATTN_CASES = [
    # (B, H, Hkv, Sq, Sk, D, causal, window, dtype) — tests/test_kernels.py
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 8, 8, 128, 128, 128, False, 0, "float32"),
    (2, 4, 1, 256, 256, 64, True, 64, "float32"),
    (1, 2, 2, 128, 128, 64, True, 0, "bfloat16"),
    (1, 4, 2, 64, 64, 32, True, 0, "float32"),
    # head dim 80 (zamba2-2.7b's), which every device path of K1 takes
    (1, 4, 2, 128, 128, 80, True, 0, "float32"),
    (1, 2, 2, 128, 128, 80, True, 0, "bfloat16"),
]

DECODE_CASES = [
    # (B, H, Hkv, Sk, D) — single-token query against a cache
    (3, 4, 2, 128, 64),
    (3, 4, 2, 256, 64),
    (3, 4, 2, 384, 64),
    (5, 8, 1, 256, 64),
    (7, 2, 2, 192, 32),
    (1, 4, 4, 512, 128),
    (3, 4, 2, 128, 80),
    (2, 32, 8, 512, 64),        # the granite serving path's decode, batch 2
]

REPACK_CASES = [(16, 8, 32, 10), (8, 16, 16, 8), (32, 8, 128, 32)]

# (B, H, Hkv, Sq, Sk, D, causal, window) in fp32 for the gradients: GQA,
# Hkv = H, head dim 80, a window, non-causal; chunked_attention takes
# chunks of 32 (Sq, Sk multiples of 32)
GRAD_CASES = [
    (2, 4, 2, 64, 64, 64, True, 0),
    (1, 4, 1, 96, 96, 16, True, 24),
    (1, 4, 2, 64, 64, 80, True, 0),
    (1, 2, 2, 64, 64, 32, False, 0),
    (2, 8, 2, 32, 32, 128, True, 16),
]
#: fp32 gradients through softmax attention; both sides in fp32 from the
#: same inputs, summation orders differ
GRAD_TOL = 2e-5

# K1's backward on the card, tests/test_torch_gpu.py's BWD_CASES: (B, H,
# Hkv, Sq, Sk, causal, window); GQA, Hkv = H, windows, Sq = Sk not a
# multiple of 64, Sq < Sk
BWD_CASES = [
    (2, 4, 2, 256, 256, True, 0),
    (1, 4, 1, 200, 200, True, 0),
    (2, 8, 2, 77, 77, True, 40),
    (1, 4, 4, 130, 130, False, 0),
    (1, 4, 2, 100, 160, True, 0),
    (1, 2, 2, 64, 64, False, 24),
]
#: the backward's bf16 bound on the card (BWD_TOL["bfloat16"] there)
BWD_TOL_BF16 = 2e-2


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


@pytest.mark.parametrize("dtype,rows,path", [
    (torch.bfloat16, 1, "split_decode"), (torch.float32, 4, "split_decode"),
    (torch.bfloat16, 16, "split_decode"), (torch.float32, 16, "split_decode"),
    (torch.bfloat16, 17, "mma"), (torch.bfloat16, 1024, "mma"),
    (torch.float32, 17, "fma"), (torch.float32, 1024, "fma")])
def test_flash_path_choice(dtype, rows, path):
    """K1's path is a pure function of the dtype and the query rows per KV
    head, (H / Hkv) * Sq: decode-shaped calls split the keys, prefill takes
    the tensor cores in bf16 and fp32 FMAs in fp32."""
    assert fa.select_path(dtype, rows) == path


@pytest.mark.parametrize("causal,kv_len,sq,sk,mask", [
    (True, None, 256, 256, "causal"),      # a decoder's prefill
    (True, None, 100, 256, "causal"),
    (False, 384, 1, 512, "kv_len"),        # a decode step over its cache
    (False, torch.tensor(384, dtype=torch.int32), 1, 512, "kv_len"),
    (False, None, 512, 512, "square"),     # an encoder's self-attention
    (False, None, 256, 512, "rect"),       # cross-attention prefill
    (False, None, 1, 512, "rect"),         # a cross decode step
])
def test_flash_mask_count_key(causal, kv_len, sq, sk, mask):
    """The mask a K1 call is counted under, forward and backward: the
    encoder-decoder's encoder, cross-attention and decode calls each have
    their own, so a run's launches split by role without a config's
    layer counts."""
    assert fa.mask_of(causal, kv_len, sq, sk) == mask
    assert mask in fa.MASKS


def test_flash_cpu_calls_count_no_launch():
    """On CPU tensors K1 takes its plain version, which is no launch: no
    count moves, by path or by mask."""
    ops.reset_counts()
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 8, 16)
    ops.flash_attention(q, k, k, causal=False)
    assert fa.flash_attention.mask_launches == dict.fromkeys(fa.MASKS, 0)
    assert fa.flash_attention.path_launches == dict.fromkeys(fa.PATHS, 0)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch,decode,prefill", [
    ("granite-3-2b", "split_decode", "mma"),
    ("zamba2-2.7b", "split_decode", "mma"),      # G = 1, D = 80
])
def test_the_models_attention_calls_take_their_paths(arch, decode, prefill):
    """Each model's bf16 attention calls: decode (one query row per query
    head, G rows per KV head) splits the keys; prefill and training
    (S = 256 to 4096) take the tensor cores.  zamba2's MHA (G = 1) at head
    dim 80 is a shape the kernel was built for."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    G = cfg.num_heads // cfg.num_kv_heads
    assert cfg.head_dim in fa.HEAD_DIMS
    assert fa.select_path(torch.bfloat16, G * 1) == decode
    for S in (256, 1024, 4096):
        assert fa.select_path(torch.bfloat16, G * S) == prefill
    assert fa.select_bwd_path(torch.bfloat16) == "wgmma"
    q = torch.zeros(2, cfg.num_heads, 4, cfg.head_dim, dtype=torch.bfloat16)
    k = torch.zeros(2, cfg.num_kv_heads, 8, cfg.head_dim,
                    dtype=torch.bfloat16)
    fa._check(q, k, k)


@pytest.mark.parametrize("bh,sk,sms,want", [
    (128, 512, 132, 1),      # granite decode (B=16, Hkv=8): a CTA a head
    (512, 512, 132, 1),      # zamba2 decode (B=16, Hkv=32, G=1)
    (128, 384, 132, 1),
    (16, 512, 132, 8),       # few CTAs: split, one tile each
    (8, 64, 132, 1),         # one tile: one split
    (4096, 512, 132, 1),     # enough CTAs already
    (128, 4096, 132, 8),     # 64 tiles: 8 per CTA at most
    (128, 4160, 132, 9),     # 65 tiles: 9 splits of 8, the last of 1
    (32, 512, 132, 4),       # 4 splits of 2 tiles fill the card
    (64, 100, 132, 2),       # a ragged tile
    (1, 0, 132, 1),          # an empty buffer still has a split
])
def test_decode_split_count(bh, sk, sms, want):
    """The split count depends on B * Hkv, the buffer length and the SM
    count only (never kv_len); every split holds at least one key and at
    most SPLIT_MAX_TILES tiles."""
    n = fa.decode_splits(bh, sk, sms)
    assert n == want
    tiles = max(1, -(-sk // fa.TILE_K))
    per = -(-tiles // n)
    assert per * (n - 1) < tiles <= per * n
    assert per <= fa.SPLIT_MAX_TILES


@pytest.mark.parametrize("D", [8, 24, 40, 48, 96, 256])
def test_flash_check_rejects_head_dims(D):
    """The wrapper's checks run on the host: a head dim that is not a
    multiple of 16, or one no device path was built for, is refused before
    any launch."""
    q = torch.zeros(1, 2, 4, D)
    match = "multiple of 16" if D % 16 else "not in"
    with pytest.raises(ValueError, match=match):
        fa._check(q, q, q)


def test_flash_check_accepts_every_head_dim():
    for D in fa.HEAD_DIMS:
        q = torch.zeros(1, 2, 4, D, dtype=torch.bfloat16)
        fa._check(q, q, q)
    q = torch.zeros(1, 2, 4, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa._check(q, q, q)
    k = torch.zeros(1, 2, 8, 68)[..., :64]       # rows of 272 bytes: ok
    fa._check(torch.zeros(1, 2, 4, 64), k, k)
    k = torch.zeros(1, 2, 8, 66)[..., :64]       # rows of 264 bytes
    with pytest.raises(ValueError, match="16-byte"):
        fa._check(torch.zeros(1, 2, 4, 64), k, k)


def test_cpu_calls_are_not_launches():
    ops.reset_counts()
    q = torch.zeros(1, 2, 4, 32)
    ops.flash_attention(q, q, q)
    ops.repack(torch.zeros(4, 2, 3), [3, 0])
    ops.ssd_scan(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2),
                 torch.zeros(1, 8, 16), torch.zeros(1, 8, 16), chunk=4)
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0, "repack": 0,
                                   "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert fa.flash_attention.path_launches == {"fma": 0, "mma": 0,
                                                "split_decode": 0}


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device with no kernel (neither the CPU, a
    card, nor meta, whose calls return shapes only)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_no_silent_fallback_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; it
    never takes the plain version (meta tensors, a dry run's, take no
    arithmetic at all: tests/test_torch_launch.py)."""
    def elsewhere(*shape):
        return torch.zeros(*shape).as_subclass(_Elsewhere)

    q = elsewhere(1, 2, 4, 32)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.repack(elsewhere(4, 2, 3), [0])
    x, a, bc = (elsewhere(*s) for s in [(1, 8, 2, 16), (1, 8, 2), (1, 8, 16)])
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.ssd_scan(x, a, bc, bc, chunk=4)


def test_cpu_calls_count_no_path():
    """No wrapper counts a CPU call on any of its device paths."""
    ops.reset_counts()
    ops.repack(torch.zeros(4, 2, 8), [3, 0, 3])
    ops.ssd_scan(torch.zeros(1, 64, 2, 16, dtype=torch.bfloat16),
                 torch.zeros(1, 64, 2),
                 torch.zeros(1, 64, 16, dtype=torch.bfloat16),
                 torch.zeros(1, 64, 16, dtype=torch.bfloat16), chunk=64)
    assert {n: fn.path_launches for n, fn in ops.KERNELS.items()} == {
        "flash_attention": {"fma": 0, "mma": 0, "split_decode": 0},
        "flash_attention_bwd": {"fma": 0, "wgmma": 0},
        "repack": {"bytes": 0, "bulk": 0},
        "ssd_scan": {"fma": 0, "wgmma": 0},
        "ssd_scan_bwd": {"fma": 0, "wgmma": 0}}


@pytest.mark.parametrize("block_bytes,src,out,path", [
    (512 * 1024, 0, 1 << 20, "bulk"),            # the embedding table's
    (16, 32, 48, "bulk"),
    (15, 0, 0, "bytes"),                         # 16-byte sizes only
    (1024, 8, 0, "bytes"),                       # 16-byte addresses only
    (1024, 0, 4, "bytes"),
])
def test_repack_path_choice(block_bytes, src, out, path):
    """K2 takes its bulk (TMA) path when the blocks and both base pointers
    allow 16-byte bulk copies, else its byte path."""
    assert bc.select_path(block_bytes, src, out) == path


@pytest.mark.parametrize("idx", [[0, 4], [-1], np.array([2, 9]),
                                 torch.tensor([5])])
def test_repack_refuses_a_bad_index_before_any_upload(monkeypatch, idx):
    """Every index is range-checked on the host: an out-of-range one raises
    before anything is pinned or copied to the card."""
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a, **k: pinned.append(self) or self)
    with pytest.raises(IndexError, match="out of range"):
        bc.upload_index(idx, 4, "cuda")
    assert pinned == []


def test_repack_refuses_device_resident_indices(monkeypatch):
    """The indices must be host data (they are validated before upload)."""
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a, **k: pinned.append(self) or self)
    for dt in (torch.int32, torch.int64):
        with pytest.raises(ValueError, match="host data"):
            bc.upload_index(torch.zeros(3, dtype=dt, device="meta"), 4,
                            "cuda")
    assert pinned == []


def test_repack_upload_pins_then_copies_without_blocking(monkeypatch):
    """A valid index vector is checked, converted to int32, pinned, and only
    then handed to the asynchronous copy."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a, **k: calls.append("pin") or self)
    monkeypatch.setattr(bc, "_copy_async",
                        lambda t, dev: calls.append(("copy", dev.type)) or t)
    out = bc.upload_index(np.array([3, 0, 3]), 4, "cuda")
    assert calls == ["pin", ("copy", "cuda")]
    assert out.dtype == torch.int32 and out.tolist() == [3, 0, 3]


def _grad_inputs(B, H, Hkv, Sq, Sk, D, seed=6):
    rng = np.random.default_rng(seed)
    return [_np(rng, s) for s in [(B, H, Sq, D), (B, Hkv, Sk, D),
                                  (B, Hkv, Sk, D), (B, H, Sq, D)]]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", GRAD_CASES)
def test_attention_grads_match_jax(B, H, Hkv, Sq, Sk, D, causal, window):
    """The port's attention differentiated on the CPU (autograd through its
    plain version, the path every CPU call takes) equals ``jax.grad`` of the
    JAX package's kernel reference and of ``chunked_attention``, the
    function the JAX model differentiates."""
    q, k, v, do = _grad_inputs(B, H, Hkv, Sq, Sk, D)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))

    def ref_loss(q_, k_, v_):
        o = jref.attention_reference(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(o * do)

    def chunked_loss(q_, k_, v_):
        t = lambda x: jnp.transpose(x, (0, 2, 1, 3))
        o = chunked_attention(t(q_), t(k_), t(v_), causal=causal,
                              window=window, chunk_q=32, chunk_k=32)
        return jnp.sum(t(o) * do)

    for loss in (ref_loss, chunked_loss):
        exp = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        for name, a, b in zip(("dq", "dk", "dv"), got, exp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{loss.__name__} {name}")


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", GRAD_CASES + [
    (1, 4, 2, 40, 72, 64, True, 0),          # Sq < Sk, top-left causal
    (1, 2, 1, 50, 50, 16, True, 8)])         # Sq not a multiple of 64
def test_attention_backward_reference_equals_autograd(B, H, Hkv, Sq, Sk, D,
                                                      causal, window):
    """The plain backward from the row log-sum-exp (what the backward
    kernel is held to on the card) equals torch autograd of the plain
    forward; its lse equals the log of the softmax denominator."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _grad_inputs(B, H, Hkv, Sq, Sk, D, seed=7))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    exp = torch.autograd.grad(out, leaves, do)
    lse = attention_lse_reference(q, k, causal=causal, window=window)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    got = fa.flash_attention_bwd(q, k, v, out.detach(), do, lse,
                                 causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   msg=name)


def test_cpu_backward_is_not_a_launch():
    ops.reset_counts()
    q = torch.zeros(1, 2, 4, 32, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    fa.flash_attention_bwd(q.detach(), q.detach(), q.detach(), q.detach(),
                           q.detach(), torch.zeros(1, 2, 4))
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    assert fa.flash_attention_bwd.path_launches == {"fma": 0, "wgmma": 0}


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "fma")])
def test_flash_bwd_path_choice(dtype, path):
    """K1's backward path is a pure function of the dtype: the tensor
    cores for bf16, fp32 FMAs for fp32 (never TF32)."""
    assert fa.select_bwd_path(dtype) == path
    assert path in fa.BWD_PATHS


def test_needs_grad():
    """The one condition under which a wrapper's call must carry a
    gradient (K1 and K3 on a card then take their autograd functions):
    grad mode on and some input requiring a gradient."""
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not needs_grad(a)
    assert not needs_grad(a, a.detach())
    assert needs_grad(a, b)
    assert needs_grad(b * 2)                     # a non-leaf result
    with torch.no_grad():
        assert not needs_grad(a, b)
    with torch.inference_mode():
        assert not needs_grad(b)
    with torch.enable_grad():
        assert needs_grad(b)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,window", BWD_CASES)
def test_bwd_wgmma_rounding_model_holds_the_tolerance(B, H, Hkv, Sq, Sk,
                                                      causal, window, D):
    """The backward's wgmma path rounds P and dS once each to bf16 before
    their products, sums in fp32 in tile order and rounds each output once
    (``bwd_rounding.model_grads``): at every case and head dim the card's
    tests run, that keeps dq, dk, dv within the bf16 bound of the plain
    version."""
    args = bwd_rounding.inputs(1, B, H, Hkv, Sq, Sk, D, causal=causal,
                               window=window)
    kw = dict(causal=causal, window=window)
    got = bwd_rounding.model_grads(*args, **kw)
    exp = attention_backward_reference(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        assert bwd_rounding.worst_ratio(a, b, BWD_TOL_BF16) < 1.0, name


def test_bwd_wgmma_rounding_model_at_the_training_length():
    """The longest sums the path takes: one KV head of the training shape
    (G = 4 query heads, S = 4096, D = 64, causal), each dk / dv entry a sum
    over up to 16,384 rounded products; dS rounded once (no hi + lo split)
    stays inside the bf16 bound with room (about a third of it)."""
    args = bwd_rounding.inputs(0, 1, 4, 1, 4096, 4096, 64)
    got = bwd_rounding.model_grads(*args)
    exp = bwd_rounding.reference_grads(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        assert bwd_rounding.worst_ratio(a, b, BWD_TOL_BF16) < 0.5, name
