"""Plain reference of the conjugate-gradient application: the problem
from the seed, and the exact solutions it judges the program's by.

A frozen copy of the equations, in plain PyTorch: it imports nothing of
the program under test.  :func:`make_matrix` makes A = M M^T + n I
(M's entries 0.1 N(0, 1)) on the device from one generator; the product
M M^T is formed in TF32 (data, made once a run: in fp32 it would take
seconds of every run's set-up), and the same seed gives the same A, bit
for bit.  :func:`rhs` is the right-hand side b_k of the job's k-th
solve, N(0, 1), drawn from the seed and k alone.  :func:`solve` is
plain CG in float64 over blocks of A's rows, on any number of
right-hand sides at once, run until each recursive residual is under
1e-15 of its b: A's condition number is about 1.04, so some ten
iterations reach float64's rounding.  :func:`cg` is the iteration the
program runs, in float32 with TF32 off; ``precision="tf32"`` is the
control, the same iteration with A and each direction rounded to TF32's
10-bit mantissa before the product, as TF32 arithmetic takes them.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: rows of A promoted to float64 at a time
ROWS = 4096


def make_matrix(n: int, seed: int, device) -> torch.Tensor:
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gen = torch.Generator(device=device).manual_seed(seed)
        m = torch.randn(n, n, generator=gen, device=device).mul_(0.1)
        a = m @ m.T
        del m
        a.diagonal().add_(n)
        return a
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def rhs(n: int, seed: int, k: int, device) -> torch.Tensor:
    """b of solve ``k``: its own generator, seeded from the seed and k
    (k < 2^24)."""
    gen = torch.Generator(device=device).manual_seed((seed << 24) + k)
    return torch.randn(n, generator=gen, device=device)


def matvec64(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x in float64 (x one vector or a column each), ``ROWS`` rows of
    A at a time."""
    x = x.double()
    out = torch.empty((a.shape[0],) + x.shape[1:], dtype=torch.float64,
                      device=a.device)
    for i in range(0, a.shape[0], ROWS):
        out[i:i + ROWS] = a[i:i + ROWS].double() @ x
    return out


def solve(a: torch.Tensor, b: torch.Tensor, max_iter: int = 200,
          tol: float = 1e-15) -> torch.Tensor:
    """x with A x = b (b one vector or a column each): CG in float64,
    each column on its own, until every |r| / |b| < tol."""
    b2 = b.double().reshape(b.shape[0], -1)
    x = torch.zeros_like(b2)
    r = b2.clone()
    p = r.clone()
    rs = (r * r).sum(0)
    bn = rs.sqrt()
    for _ in range(max_iter):
        q = matvec64(a, p)
        pq = (p * q).sum(0)
        alpha = torch.where(pq != 0, rs / pq, 0.0)
        x += alpha * p
        r -= alpha * q
        rs_new = (r * r).sum(0)
        if bool((rs_new.sqrt() < tol * bn).all()):
            break
        p = r + torch.where(rs != 0, rs_new / rs, 0.0) * p
        rs = rs_new
    return x.reshape(b.shape)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10-bit mantissa (ties
    away from zero), as float32."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def cg(a: torch.Tensor, b: torch.Tensor, iters: int,
       precision: str = "fp32") -> torch.Tensor:
    """``iters`` iterations of the application's CG from x = 0, its
    guards included; returns x."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if precision == "tf32":
            a = round_tf32(a)
        x = torch.zeros_like(b)
        r, p = b.clone(), b.clone()
        rs = torch.dot(b, b)
        for _ in range(iters):
            q = a @ (round_tf32(p) if precision == "tf32" else p)
            denom = torch.dot(p, q)
            alpha = torch.where(denom.abs() > 1e-30, rs / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * q
            rs_new = torch.dot(r, r)
            beta = torch.where(rs > 1e-30, rs_new / rs, 0.0)
            p = r + beta * p
            rs = rs_new
        return x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def rel_err(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """|x - x_ref|_2 / |x_ref|_2 in float64."""
    x_ref = x_ref.double()
    return float(torch.linalg.vector_norm(x.double() - x_ref) /
                 torch.linalg.vector_norm(x_ref))
