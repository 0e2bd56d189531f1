"""The plain references against the port on the CPU, at tiny sizes
(granite's smoke widths, CG at n = 512), through the benchmark's own
drivers; the references' inputs from the seed; and the control, which
has to come out as not correct."""
import numpy as np
import pytest
import torch

from port_bench import harness, tiny

SEED = 2 ** 33 + 17                 # seeds may pass 32 bits
LM = "granite-3-2b.train-elastic"
CG = "cg-32768.resize-every-5"


@pytest.mark.parametrize("cell", [LM, CG, "cg-32768.static"])
@pytest.mark.parametrize("trace", [False, True])
def test_port_agrees_with_the_reference(cell, trace):
    out = tiny.cpu_run(tiny.tiny_cell(cell), SEED, trace=trace)
    assert harness.judge(out.checks, out.failed), out.checks
    assert out.attempted >= 1 and out.steps >= 1
    line = harness.result_line(
        harness.Run(cell=tiny.tiny_cell(cell), device=torch.device("cpu"),
                    seconds=0.2, seed=SEED, trace=trace, t0=0.0), out)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in
                                        tiny.tiny_cell(cell).end_to_end}


def test_weights_and_batches_from_the_seed():
    ref = harness.load_module("refs/dense_lm.py")
    a = ref.make_params(tiny.TINY_LM, SEED, "cpu")
    b = ref.make_params(tiny.TINY_LM, SEED, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = ref.make_params(tiny.TINY_LM, SEED + 1, "cpu")
    assert not torch.equal(a["layers/attn/wq"], c["layers/attn/wq"])
    b0 = ref.make_batch(tiny.TINY_LM, 4, 64, SEED, 0)
    b1 = ref.make_batch(tiny.TINY_LM, 4, 64, SEED, 1)
    rows = np.concatenate([b0["tokens"], b1["tokens"]])
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert (b0["labels"][:, :-1] == b0["tokens"][:, 1:]).all()
    cg = harness.load_module("refs/cg.py")
    assert torch.equal(cg.make_matrix(64, SEED, "cpu"),
                       cg.make_matrix(64, SEED, "cpu"))
    assert torch.equal(cg.rhs(64, SEED, 3, "cpu"), cg.rhs(64, SEED, 3, "cpu"))
    bs = [cg.rhs(64, SEED, k, "cpu") for k in range(3)]
    bs.append(cg.rhs(64, SEED + 1, 0, "cpu"))
    assert len({b.numpy().tobytes() for b in bs}) == 4


def test_cg_reference_solves():
    cg = harness.load_module("refs/cg.py")
    a = cg.make_matrix(256, SEED, "cpu")
    bs = torch.stack([cg.rhs(256, SEED, k, "cpu") for k in range(3)], 1)
    xs = cg.solve(a, bs)
    for k in range(3):
        x = cg.solve(a, bs[:, k].contiguous())
        assert torch.equal(x, xs[:, k]) or float(
            (x - xs[:, k]).norm() / x.norm()) < 1e-14
        r = bs[:, k].double() - a.double() @ xs[:, k]
        assert float(r.norm() / bs[:, k].double().norm()) < 1e-12
    assert cg.round_tf32(torch.tensor([1.0 + 2 ** -12])).item() == 1.0


def _control_readings(cell):
    import sys
    sys.path.insert(0, str(harness.BENCH_DIR))
    control = harness.load_module("control.py")
    return list(control.readings(tiny.tiny_cell(cell), [SEED], [],
                                 torch.device("cpu")))


@pytest.mark.parametrize("cell", [LM, CG])
def test_the_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place: fp8 products for training (the tiny program runs
    fp32, so its limits are fp32's), TF32 for CG."""
    prog, ctrl = _control_readings(cell)
    assert prog["what"] == "program" and ctrl["what"].startswith("control")
    lim = tiny.tiny_cell(cell).limits
    names = [k for k in ("loss_gap", "grad_gap", "grad_diff", "change_gap",
                         "x_err")
             if k in ctrl]
    assert all(prog[k] <= lim[k] for k in names)
    assert any(ctrl[k] > lim[k] for k in names), ctrl
