"""The port's serving slice against the JAX package's: elastic decode of
``granite-3-2b-smoke`` (a KV cache), ``mamba2-370m-smoke`` (an SSM state
and conv tails) and ``zamba2-2.7b-smoke`` (both: the SSM cache and one KV
cache per group, ``shared_kv``) on the CPU, from the same parameters.

Greedy tokens must be equal (float32 logits on both sides; argmax picks
the first maximum in both), unchanged by a 4 -> 8 -> 2 resize, and every
resize must report the JAX run's ``bytes_moved``, overall and per pattern.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.serve import decode_demo as j_decode_demo
from repro_torch import dmr
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.parallel.mesh import Placement, logical_workers
from repro_torch.serve import decode_demo
from tests.util import run_devices

ARCHS = ["granite-3-2b-smoke", "mamba2-370m-smoke", "zamba2-2.7b-smoke"]
RUN = dict(batch=8, prompt_len=8, decode_steps=8, cache_len=64)
SCHEDULE = {10: 8, 13: 2}

JAX_ELASTIC = r"""
import json, warnings; warnings.filterwarnings("ignore")
from repro.serve import decode_demo
out = decode_demo("%s", schedule=%r, **%r)
print("JAX_ELASTIC" + json.dumps({
    "tokens": out["tokens"].tolist(),
    "events": [[e.action, e.from_procs, e.to_procs, e.transfer.bytes_moved,
                {k: s.bytes_moved for k, s in e.per_pattern.items()}]
               for e in out["events"]]}))
"""


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def jax_params(arch):
    jp = JM.init_params(jget_config(arch), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def port_runs(arch, jax_params):
    params = params_from_numpy(jax_params)
    base = decode_demo(arch, workers=8, device="cpu", params=params, **RUN)
    ela = decode_demo(arch, workers=8, device="cpu", params=params,
                      schedule=SCHEDULE, **RUN)
    return base, ela


def test_tokens_match_the_jax_serve_step(arch, jax_params):
    """One worker, no resize: the port's greedy tokens are the JAX
    ``decode_demo``'s from the same parameters and prompts."""
    small = dict(batch=4, prompt_len=8, decode_steps=8, cache_len=64)
    ref = j_decode_demo(arch, **small)
    out = decode_demo(arch, device="cpu",
                      params=params_from_numpy(jax_params), **small)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert out["tokens"].shape == (4, 8)


#: the dense configs beside granite, at smoke size (head dim 16, G = 2,
#: as ``reduced()`` cuts every config), then small configs at head dim 128
#: with each full config's GQA ratio: phi4-mini's G = 3, qwen2.5's G = 5
#: (with its QKV bias and rope_theta), internlm2's G = 6
DENSE_CASES = [("phi4-mini-3.8b-smoke", {}), ("qwen2.5-32b-smoke", {}),
               ("phi4-mini-3.8b-smoke",
                dict(num_heads=6, num_kv_heads=2, head_dim=128)),
               ("qwen2.5-32b-smoke",
                dict(num_heads=10, num_kv_heads=2, head_dim=128)),
               ("internlm2-20b-smoke",
                dict(num_heads=12, num_kv_heads=2, head_dim=128))]


@pytest.mark.parametrize("name,shape", DENSE_CASES,
                         ids=["phi4", "qwen2.5", "phi4-D128-G3",
                              "qwen2.5-D128-G5", "internlm2-D128-G6"])
def test_dense_config_tokens_match_the_jax_serve_step(name, shape):
    """``decode_demo`` on one worker against the JAX serve step's greedy
    tokens from the same parameters and prompts (prefill-by-decode, then
    greedy decode), in one process."""
    from dataclasses import replace

    from repro.models.train import make_serve_step as j_make_serve_step
    jcfg = replace(jget_config(name), **shape)
    cfg = replace(get_config(name), **shape)
    assert cfg.__dict__ == jcfg.__dict__
    small = dict(batch=4, prompt_len=8, decode_steps=8, cache_len=32)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    out = decode_demo(cfg, device="cpu",
                      params=params_from_numpy(jax.tree.map(np.asarray, jp)),
                      **small)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (small["batch"], small["prompt_len"]),
        dtype=np.int32)
    serve = jax.jit(j_make_serve_step(jcfg))
    cache = JM.init_cache(jcfg, small["batch"], small["cache_len"],
                          enc_len=small["cache_len"])
    want = []
    for i in range(small["prompt_len"] + small["decode_steps"] - 1):
        tok = prompts[:, i:i + 1] if i < small["prompt_len"] else tok
        tok, cache = serve(jp, cache, jax.numpy.asarray(tok), i)
        tok = np.asarray(tok)
        if i >= small["prompt_len"] - 1:
            want.append(tok[:, 0])
    np.testing.assert_array_equal(out["tokens"], np.stack(want, axis=1))


def test_resize_leaves_tokens_unchanged(port_runs):
    base, ela = port_runs
    np.testing.assert_array_equal(base["tokens"], ela["tokens"])
    assert base["events"] == [] and base["sizes"] == [(0, 4)]
    assert [e.action for e in ela["events"]] == ["expand", "shrink"]
    assert ela["sizes"] == [(0, 4), (10, 8), (13, 2)]


def test_elastic_run_matches_jax_on_8_devices(arch, port_runs):
    """Tokens and byte accounting equal the JAX run on 8 host devices."""
    out = run_devices(JAX_ELASTIC % (arch, SCHEDULE, RUN), n_devices=8)
    ref = json.loads(out.split("JAX_ELASTIC", 1)[1])
    _, ela = port_runs
    np.testing.assert_array_equal(ela["tokens"], np.asarray(ref["tokens"]))
    got = [[e.action, e.from_procs, e.to_procs, e.transfer.bytes_moved,
            {k: s.bytes_moved for k, s in e.per_pattern.items()}]
           for e in ela["events"]]
    assert got == ref["events"]


def test_decode_demo_takes_a_config():
    """``decode_demo`` takes a config as well as a name: the named
    config gives the named run's tokens, one cut to one layer others."""
    from dataclasses import replace
    small = dict(batch=2, prompt_len=4, decode_steps=4, cache_len=16,
                 device="cpu")
    cfg = get_config(ARCHS[1])
    by_name = decode_demo(ARCHS[1], **small)["tokens"]
    np.testing.assert_array_equal(decode_demo(cfg, **small)["tokens"],
                                  by_name)
    one = decode_demo(replace(cfg, num_layers=1), **small)["tokens"]
    assert one.shape == by_name.shape and not np.array_equal(one, by_name)


def test_decode_demo_defaults_to_the_card(monkeypatch):
    """Without ``device="cpu"`` the entry point asks for a card, and raises
    when there is none instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_demo(ARCHS[0], batch=2, prompt_len=2, decode_steps=1,
                    cache_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dmr.MalleableRunner(dmr.App(), dmr.set_parameters(1, 2, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_on_the_cpu(capsys, arch):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--batch", "8", "--prompt-len", "4",
          "--decode-steps", "4", "--cache-len", "16", "--workers", "8",
          "--device", "cpu", "--resize-at", "6", "--resize-to", "8"])
    out = capsys.readouterr().out
    assert "resize @ step 6: expand 4->8" in out
    assert out.count("seq[") == 4


# -- the runner on a toy app --------------------------------------------

def _toy_app(n_rows=8):
    def init(mesh):
        return {"x": torch.arange(n_rows * 3, dtype=torch.float32).reshape(
            n_rows, 3), "w": torch.ones(5)}

    def shardings(mesh):
        axis = 0 if n_rows % mesh.size == 0 else None
        return {"x": Placement(mesh, axis), "w": Placement(mesh)}

    def step(mesh):
        def fn(state, i):
            return {"x": state["x"] + 1, "w": state["w"]}, mesh.size
        return fn

    return dmr.App(init=init, shardings=shardings, step=step,
                   patterns={"w": "replicate"})


def test_runner_failure_shrinks_onto_survivors():
    workers = logical_workers(8, "cpu")
    runner = dmr.MalleableRunner(_toy_app(), dmr.set_parameters(1, 8, 4),
                                 rms={1: 8}, devices=workers)
    state = runner.init()
    for i in range(3):
        state = dmr.reconfig(runner, state, i)
        state, n = runner.step(state, i)
    assert n == 8
    state = runner.handle_failure(state, 3, workers[3:8])
    assert runner.current == 2 and len(runner.devices) == 3
    ev = runner.events[-1]
    assert (ev.action, ev.from_procs, ev.to_procs) == ("shrink", 8, 2)
    # default: full resident bytes of x; replicate: w x 2 workers
    assert ev.per_pattern["default"].bytes_moved == 8 * 3 * 4
    assert ev.per_pattern["replicate"].bytes_moved == 5 * 4 * 2
    np.testing.assert_array_equal(state["x"].numpy(),
                                  np.arange(24).reshape(8, 3) + 3)
    # the live pool no longer fits 8: an expand collapses to a no-op
    assert runner.apply_resize(state, 4, dmr.Action("expand", 8)) is state


@pytest.mark.parametrize("policy", ["algorithm2", "throughput-greedy"])
def test_runner_policy_matches_jax(policy):
    """With ``policy=`` the runner runs the policy against its own pool
    (every worker it does not use is free, no queue) and resizes where the
    JAX package's policy decides."""
    from repro import dmr as jdmr
    params = dmr.set_parameters(1, 8, 2)
    runner = dmr.MalleableRunner(_toy_app(), params, policy=policy,
                                 devices=logical_workers(8, "cpu"))
    state = runner.init()
    want, cur = [], 2
    for i in range(3):
        act = jdmr.get_policy(policy).decide(
            cur, jdmr.set_parameters(1, 8, 2),
            jdmr.ClusterView(available=8 - cur, pending_min_sizes=[]))
        if act.kind != "none" and act.target != cur:
            want.append((i, act.kind, cur, act.target))
            cur = act.target
        state = dmr.reconfig(runner, state, i)
        state, n = runner.step(state, i)
        assert n == cur
    assert [(e.step, e.action, e.from_procs, e.to_procs)
            for e in runner.events] == want


def test_runner_inhibitor_defers_a_scripted_resize():
    """``sched_iterations=3`` lets the runner query at steps 0, 3, 6, ...:
    a resize scheduled for step 1 fires at step 3."""
    runner = dmr.MalleableRunner(
        _toy_app(), dmr.set_parameters(1, 8, 4, sched_iterations=3),
        rms={1: 8}, devices=logical_workers(8, "cpu"))
    state = runner.init()
    for i in range(6):
        state = dmr.reconfig(runner, state, i)
        state, n = runner.step(state, i)
        assert n == (4 if i < 3 else 8)
    assert [(e.step, e.action) for e in runner.events] == [(3, "expand")]


def test_runner_rejects_a_short_pool_and_two_deciders():
    with pytest.raises(ValueError, match="cannot reach max_procs=8"):
        dmr.MalleableRunner(_toy_app(), dmr.set_parameters(1, 8, 4),
                            devices=logical_workers(4, "cpu"))
    with pytest.raises(ValueError, match="either rms= or policy="):
        dmr.MalleableRunner(_toy_app(), dmr.set_parameters(1, 8, 4),
                            rms={1: 8}, policy="algorithm2",
                            devices=logical_workers(8, "cpu"))
