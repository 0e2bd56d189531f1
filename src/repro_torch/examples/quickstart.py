"""Quickstart: make an LM training job malleable in ~10 lines, on the port
(``examples/quickstart.py`` in the JAX package).

The loop in :func:`main` is the paper's Listing 2, in PyTorch: one
``dmr.reconfig`` call at the top of each iteration is the DMR_RECONFIG
point; everything else — resource negotiation with the RMS, state
redistribution, the step swap — happens inside the library.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from repro_torch import dmr
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.examples import Log, check, cli
from repro_torch.parallel.mesh import logical_workers

ARCH = "granite-3-2b-smoke"                              # tiny dense LM
SHAPE = ShapeConfig("quickstart", "train", seq_len=64, global_batch=8)


def main(device=None):
    """14 steps, 4 -> 8 -> 2 at steps 4 and 10.  Returns ``(runner,
    state, out)``."""
    say = Log()
    app = lm_train_app(get_config(ARCH), SHAPE)          # the "user code"
    params = dmr.set_parameters(2, 8, 4)                 # DMR_Set_parameters
    rms = dmr.connect({4: 8, 10: 2})                     # expand @4, shrink @10

    runner = dmr.MalleableRunner(
        app, params, rms, devices=logical_workers(params.max_procs, device))
    state, losses = runner.init(), []
    for step in range(14):
        state = dmr.reconfig(runner, state, step)        # <- DMR_RECONFIG
        state, metrics = runner.step(state, step)
        losses.append(float(metrics["loss"]))
        say(f"step {step:3d} workers {runner.current}  "
            f"loss {losses[-1]:.4f}")

    for e in runner.events:
        say(f"resize @{e.step}: {e.action} {e.from_procs}->{e.to_procs} "
            f"({e.transfer.bytes_moved/1e6:.1f} MB, "
            f"{e.transfer.seconds*1e3:.1f} ms)")
    check(len(runner.events) == 2, f"{len(runner.events)} resizes")
    say("OK")
    return runner, state, {"losses": losses, "lines": say.lines}


if __name__ == "__main__":
    cli(main)
