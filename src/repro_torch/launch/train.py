"""Elastic training command line of the port — DMRlib malleability on a live
training job (port of ``repro/launch/train.py``; ``--workers N`` logical
workers of one device take the place of ``--host-devices N``).  Runs on
the card unless ``--device cpu`` is given.

  python -m repro_torch.launch.train --arch granite-3-2b-smoke --steps 20 \\
      --min 2 --max 8 --pref 4 --resize-at 5:8 --resize-at 12:2 \\
      --workers 8 --device cpu

  # operator-driven resizes (the Slurm-RPC stand-in):
  ... --rms-file resize.json      # echo '{"target": 8}' > resize.json
"""
import argparse
import os
import tempfile


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default=None,
                   help="named shape; default: a small training shape")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--min", type=int, default=2)
    p.add_argument("--max", type=int, default=8)
    p.add_argument("--pref", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--resize-at", action="append", default=[],
                   metavar="STEP:TARGET")
    p.add_argument("--rms-file", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--workers", type=int, default=None,
                   help="logical workers in the job's pool (default: --max)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the workers (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from repro_torch import dmr
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.lm_app import lm_train_app
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.parallel.mesh import logical_workers

    cfg = get_config(args.arch)
    if args.shape:
        shape = get_shape(args.shape)
    else:
        shape = ShapeConfig("cli_train", "train", args.seq_len,
                            args.global_batch)

    opt = AdamW(learning_rate=cosine_schedule(args.lr, 10, args.steps),
                moment_dtype=cfg.opt_moment_dtype)
    app = lm_train_app(cfg, shape, opt, seed=args.seed)
    params = dmr.set_parameters(args.min, args.max, args.pref)
    if args.rms_file:
        rms = dmr.connect(f"file:{args.rms_file}")
    else:
        rms = dmr.connect({int(s.split(":")[0]): int(s.split(":")[1])
                           for s in args.resize_at})
    workers = logical_workers(args.workers or args.max, args.device)
    runner = dmr.MalleableRunner(app, params, rms, devices=workers)
    ckpt = CheckpointManager(
        args.checkpoint_dir or os.path.join(tempfile.gettempdir(),
                                            "repro_torch_ckpt"),
        every_steps=args.checkpoint_every)

    state = runner.init()
    start = int(state.step)
    print(f"# elastic train: {cfg.name} on {runner.current} workers "
          f"(min {args.min} / pref {args.pref} / max {args.max})")
    for step in range(start, args.steps):
        state = dmr.reconfig(runner, state, step)
        state, metrics = runner.step(state, step)
        loss = float(metrics["loss"])
        print(f"step {step:4d}  workers {runner.current:3d}  "
              f"loss {loss:.4f}")
        if args.checkpoint_every:
            ckpt.maybe_save(state, step)
    for e in runner.events:
        print(f"# resize @step {e.step}: {e.action} {e.from_procs}->"
              f"{e.to_procs}, moved {e.transfer.bytes_moved/1e6:.1f} MB in "
              f"{e.transfer.seconds*1e3:.1f} ms")
    print("# done")


if __name__ == "__main__":
    main()
