"""Batched serving command line of the port — a thin CLI over
``repro_torch.serve.decode_demo``.

Prefills a prompt batch, then greedy-decodes, as a malleable job on
``--workers`` logical workers of one device (the counterpart of the JAX
CLI's ``--host-devices``); ``--resize-at``/``--resize-to`` schedule an
elastic resize at a decode-step boundary through ``dmr.reconfig``, with
bit-identical tokens before and after.  Runs on the card unless
``--device cpu`` is given.

  python -m repro_torch.launch.serve --arch granite-3-2b-smoke --batch 8 \\
      --prompt-len 8 --decode-steps 8 --cache-len 64 --workers 8 \\
      --resize-at 10 --resize-to 8 --resize-at 13 --resize-to 2 --device cpu
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--workers", type=int, default=1,
                   help="logical workers in the job's pool")
    p.add_argument("--device", default="cuda",
                   help="torch device of the workers (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resize-at", type=int, action="append", default=None,
                   help="decode-path step index to resize at (repeatable; "
                        "pairs up with --resize-to)")
    p.add_argument("--resize-to", type=int, action="append", default=None,
                   help="worker count to resize to at the matching "
                        "--resize-at step")
    args = p.parse_args(argv)

    ats, tos = args.resize_at or [], args.resize_to or []
    if len(ats) != len(tos):
        p.error("--resize-at and --resize-to must pair up")
    schedule = dict(zip(ats, tos))

    from repro_torch.serve import decode_demo

    out = decode_demo(args.arch, batch=args.batch,
                      prompt_len=args.prompt_len,
                      decode_steps=args.decode_steps,
                      cache_len=args.cache_len, schedule=schedule,
                      workers=args.workers, device=args.device,
                      seed=args.seed)

    toks = out["tokens"]
    print(f"# {args.arch} on {args.device}: batch {args.batch}, prompt "
          f"{args.prompt_len}, decoded {args.decode_steps}")
    print(f"# prefill {out['prefill_s']*1e3:.1f} ms, decode "
          f"{out['decode_s']/args.decode_steps*1e3:.2f} ms/token")
    for step, size in out["sizes"]:
        print(f"# step {step}: {size} workers")
    for ev in out["events"]:
        print(f"# resize @ step {ev.step}: {ev.action} "
              f"{ev.from_procs}->{ev.to_procs} "
              f"({ev.transfer.bytes_moved/1e6:.1f} MB moved, "
              f"{ev.transfer.seconds*1e3:.1f} ms)")
    for b in range(min(args.batch, 4)):
        print(f"seq[{b}]: {toks[b].tolist()}")


if __name__ == "__main__":
    main()
