"""Producer/consumer aligner — the paper's irregular application (HPG,
§4.3), on the port (``examples/aligner_pipeline.py`` in the JAX package).

Reader -> workers -> writer: workers k-mer-match read chunks against a
reference table; chunk boundaries make the communication pattern
irregular, so (as in the paper) the job selects non-default
redistribution — by naming a Table-1 pattern per state subtree: the
reference table is re-replicated (``patterns={"table": "replicate"}``)
while the stream cursor and accumulated counts (0-d int32 tensors) ride
the default pattern.  Minimum workers = 3 (reader + writer + 1).  The
host loop reads the cursor back every step.

    python -m repro_torch.examples.aligner_pipeline [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import dmr
from repro_torch.examples import Log, check, cli
from repro_torch.parallel.mesh import Placement, logical_workers

K = 8                       # k-mer length
REF_LEN = 1 << 14
CHUNK_READS = 256
READ_LEN = 64
TOTAL_CHUNKS = 24


def make_reference():
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, REF_LEN).astype(np.int32)
    pows = 4 ** np.arange(K)
    idx = np.arange(REF_LEN - K + 1)
    kmer_ids = (ref[idx[:, None] + np.arange(K)] * pows).sum(-1)
    table = np.zeros(4 ** K, np.int32)
    np.add.at(table, kmer_ids, 1)
    return ref, table


def reads_for_chunk(c):
    rng = np.random.default_rng(1000 + c)
    return rng.integers(0, 4, (CHUNK_READS, READ_LEN)).astype(np.int32)


_, TABLE = make_reference()

# irregular producer/consumer: the reference table re-replicates on every
# resize, everything else (scalars) moves with the default pattern
app = dmr.App(name="aligner", patterns={"table": "replicate"})


@app.shardings
def shardings(mesh):
    rep = Placement(mesh)
    return {"table": rep, "cursor": rep, "matched": rep, "total": rep}


@app.init
def init(mesh):
    dev = mesh.device
    return {"table": torch.from_numpy(TABLE).to(dev),
            "cursor": torch.zeros((), dtype=torch.int32, device=dev),
            "matched": torch.zeros((), dtype=torch.int32, device=dev),
            "total": torch.zeros((), dtype=torch.int32, device=dev)}


@app.step
def step(mesh):
    n_workers = max(mesh.devices.size - 2, 1)   # reader + writer reserved
    dev = mesh.device
    pows = 4 ** torch.arange(K, device=dev)

    def align(state, reads):
        windows = reads.unfold(1, K, 1)             # (reads, windows, K)
        ids = torch.sum(windows * pows, -1)         # (reads, windows)
        hits = state["table"][ids] > 0
        return torch.sum(torch.any(hits, dim=1))

    def fn(state, step_i):
        c = int(state["cursor"])
        todo = min(n_workers, TOTAL_CHUNKS - c)     # irregular batch
        m_total = 0
        for i in range(todo):
            reads = torch.from_numpy(reads_for_chunk(c + i)).to(dev)
            m_total += int(align(state, reads))
        state = dict(state,
                     cursor=state["cursor"] + todo,
                     matched=state["matched"] + m_total,
                     total=state["total"] + todo * CHUNK_READS)
        return state, todo

    return fn


def main(device=None):
    """The reference's loop: until the cursor reaches TOTAL_CHUNKS,
    6 -> 8 -> 3 at steps 2 and 4.  Returns ``(runner, state, out)``."""
    say = Log()
    params = dmr.set_parameters(3, 8, 6)
    runner = dmr.MalleableRunner(
        app, params, dmr.connect({2: 8, 4: 3}),
        devices=logical_workers(params.max_procs, device))
    state = runner.init()
    i, done_per_step = 0, []
    while int(state["cursor"]) < TOTAL_CHUNKS:
        state = dmr.reconfig(runner, state, i)
        state, done = runner.step(state, i)
        done_per_step.append(done)
        say(f"step {i}: workers {runner.current} processed {done} chunks "
            f"(cursor {int(state['cursor'])}/{TOTAL_CHUNKS})")
        i += 1
    matched, total = int(state["matched"]), int(state["total"])
    say(f"matched {matched}/{total} reads; resizes "
        f"{[(e.step, e.from_procs, e.to_procs) for e in runner.events]}")
    for e in runner.events:
        pat = {k: v.bytes_moved for k, v in e.per_pattern.items()}
        say(f"  resize @{e.step} pattern bytes: {pat}")
    check(total == TOTAL_CHUNKS * CHUNK_READS, f"total {total}")
    say("OK — irregular pipeline drained across resizes")
    return runner, state, {"done": done_per_step, "matched": matched,
                           "total": total, "lines": say.lines}


if __name__ == "__main__":
    cli(main)
