"""The port's linter and CLI (``repro_torch.analysis.lint`` and
``python -m repro_torch.analysis``) against the JAX package's.

Every fixture of ``tests/test_analysis_lint.py`` for the rules both
packages share (DMR102, DMR103, DMR105, DMR106), suppressions and syntax
errors gives the same ``(code, line)`` findings from both linters.  DMR101
is retargeted in the port (CUDA graphs, TorchScript, a module-level job
mesh or placement), so it has fixtures of its own; DMR104 (the JAX
package's deprecated shims) has no counterpart.  The CLIs print the same
lines and exit with the same codes; their summaries name their own
package.
"""
import json
import os
import textwrap

import pytest

import repro.analysis.__main__ as j_cli
from repro.analysis.lint import lint_source as j_lint_source
from repro_torch import dmr
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import dump_trail, lint_paths, lint_source
from repro_torch.analysis.lint import RULES
from repro_torch.parallel.mesh import logical_workers
from repro_torch.rms import materialize_live
from tests import test_analysis_lint as J
from tests.util import REPO

SHARED = {
    "dmr102_buggy_stateful": J.BUGGY_STATEFUL,
    "dmr102_buggy_explicit_flag": J.BUGGY_EXPLICIT_FLAG,
    "dmr102_fixed_declared_stateful": J.FIXED_DECLARED_STATEFUL,
    "dmr102_fixed_configure_state": J.FIXED_CONFIGURE_STATE,
    "dmr103_buggy_pattern_path": J.BUGGY_PATTERN_PATH,
    "dmr103_fixed_pattern_path": J.FIXED_PATTERN_PATH,
    "dmr103_no_dict_literal": J.NO_DICT_LITERAL,
    "dmr105_buggy_window": J.BUGGY_WINDOW,
    "dmr105_fixed_window": J.FIXED_WINDOW,
    "dmr105_ambiguous_windows": J.AMBIGUOUS_WINDOWS,
    "dmr106_buggy_direct_append": J.BUGGY_DIRECT_APPEND,
    "dmr106_buggy_rebind": J.BUGGY_REBIND,
    "dmr106_buggy_slice_and_del": J.BUGGY_SLICE_AND_DEL,
    "dmr106_fixed_contract_methods": J.FIXED_CONTRACT_METHODS,
    "dmr106_fixed_read_only": J.FIXED_READ_ONLY,
    "suppressed_dmr106": """
        def migrate(tenant, devs):
            tenant.devices.extend(devs)  # dmr: ignore[DMR106]
    """,
    "suppressed_bare": """
        def migrate(tenant, devs):
            tenant.devices.extend(devs)  # dmr: ignore
    """,
    "suppressed_other_code": """
        def migrate(tenant, devs):
            tenant.devices.extend(devs)  # dmr: ignore[DMR101]
    """,
    "suppressed_one_of_two": """
        def hack(tenant, i):
            tenant.devices[0] = None  # dmr: ignore[DMR106, DMR102]
            del tenant.devices[i]
    """,
    "syntax_error": "def broken(:\n",
}


def _found(lint, src):
    return [(f.code, f.line) for f in lint(textwrap.dedent(src))]


@pytest.mark.parametrize("name", sorted(SHARED))
def test_findings_equal_jax(name):
    """Same (code, line) findings as ``repro.analysis.lint.lint_source``."""
    assert _found(lint_source, SHARED[name]) == \
        _found(j_lint_source, SHARED[name])


def test_shared_fixtures_fire_as_the_jax_tests_say():
    """The parity above is not parity on nothing: the buggy fixtures fire."""
    codes = {n: [c for c, _ in _found(lint_source, s)]
             for n, s in SHARED.items()}
    assert codes["dmr102_buggy_stateful"] == ["DMR102"]
    assert codes["dmr103_buggy_pattern_path"] == ["DMR103"]
    assert codes["dmr105_buggy_window"] == ["DMR105"]
    assert codes["dmr106_buggy_slice_and_del"] == ["DMR106", "DMR106"]
    assert codes["suppressed_other_code"] == ["DMR106"]
    assert codes["suppressed_one_of_two"] == ["DMR106"]
    assert codes["syntax_error"] == ["DMR100"]
    assert codes["suppressed_dmr106"] == codes["suppressed_bare"] == []


def test_rules_are_the_five_shared_and_retargeted():
    assert [code for code, _ in RULES] == ["DMR101", "DMR102", "DMR103",
                                          "DMR105", "DMR106"]
    assert _found(lint_source, "from repro.core import MalleableRunner\n") \
        == []


# ----------------------------------------------------------------------
# DMR101 — stale-mesh closure, retargeted
# ----------------------------------------------------------------------

DMR101_BUGGY = {
    "jit_script_decorator": """
        import torch

        @torch.jit.script
        def update(x):
            return x + 1

        class App:
            def make_step(self, mesh):
                return update
    """,
    "jit_trace_assign": """
        import torch
        from repro_torch import dmr

        def _impl(x):
            return x * 2

        traced = torch.jit.trace(_impl, torch.ones(4))
        app = dmr.App(name="x")

        @app.step
        def step(mesh):
            def fn(state, i):
                return traced(state), {}
            return fn
    """,
    "jit_trace_partial": """
        import functools
        import torch

        tracer = functools.partial(torch.jit.trace, example_inputs=(1,))
        shared = tracer(lambda x: x)

        def make_step(mesh):
            return tracer
    """,
    "cuda_graph_capture": """
        import torch

        graph = torch.cuda.CUDAGraph()
        static_x = torch.zeros(8, device="cuda")
        with torch.cuda.graph(graph):
            static_y = static_x * 2

        def make_step(mesh):
            def fn(state, i):
                static_x.copy_(state)
                graph.replay()
                return static_y.clone(), {}
            return fn
    """,
    "make_graphed_callables": """
        import torch
        from repro_torch import dmr

        graphed = torch.cuda.make_graphed_callables(
            lambda x: x * 2, (torch.zeros(8, device="cuda"),))
        app = dmr.App(init=lambda mesh: {}, step=lambda mesh: graphed)
    """,
    "module_level_mesh": """
        from repro_torch import dmr
        from repro_torch.parallel.mesh import logical_workers, make_job_mesh

        MESH = make_job_mesh(logical_workers(8))
        app = dmr.App(name="x")

        @app.step
        def step(mesh):
            n = MESH.size
            def fn(state, i):
                return state, n
            return fn
    """,
    "module_level_placement": """
        from repro_torch.parallel.mesh import Placement, make_job_mesh

        ROWS = Placement(make_job_mesh(WORKERS), 0)

        def make_step(mesh):
            def fn(state, i):
                return state, ROWS.local_shape(state.shape)
            return fn
    """,
}

DMR101_QUIET = {
    "per_mesh_capture": """
        import torch
        from repro_torch import dmr
        from repro_torch.parallel.mesh import Placement

        app = dmr.App(name="x")

        @app.step
        def step(mesh):
            rows = Placement(mesh, 0)
            traced = torch.jit.trace(lambda x: x * mesh.size, torch.ones(4))
            graph = torch.cuda.CUDAGraph()
            def fn(state, i):
                return traced(state), rows.spec
            return fn
    """,
    "per_mesh_mesh": """
        from repro_torch.parallel.mesh import make_job_mesh

        def make_step(mesh):
            sub = make_job_mesh(list(mesh.devices.flat)[:2])
            def fn(state, i):
                return state, sub.size
            return fn
    """,
    # Dynamo guards what a compiled graph reads and recompiles on a change
    "module_level_compile": """
        import torch

        @torch.compile
        def update(x, n):
            return x * n

        compiled = torch.compile(lambda x: x + 1)

        def make_step(mesh):
            def fn(state, i):
                return compiled(update(state, mesh.size)), {}
            return fn
    """,
    "captured_but_not_read_by_a_factory": """
        import torch

        traced = torch.jit.trace(lambda x: x, torch.ones(2))

        def helper(x):
            return traced(x)
    """,
}


@pytest.mark.parametrize("name", sorted(DMR101_BUGGY))
def test_dmr101_fires_on_module_level_captures(name):
    found = lint_source(textwrap.dedent(DMR101_BUGGY[name]))
    assert "DMR101" in [f.code for f in found], found
    assert all("replays the mesh" in f.message for f in found
               if f.code == "DMR101")


@pytest.mark.parametrize("name", sorted(DMR101_QUIET))
def test_dmr101_quiet_on_per_mesh_construction(name):
    codes = [f.code for f in lint_source(textwrap.dedent(DMR101_QUIET[name]))]
    assert "DMR101" not in codes


def test_dmr101_names_what_was_captured():
    found = lint_source(textwrap.dedent(DMR101_BUGGY["cuda_graph_capture"]))
    names = sorted({f.message.split("'")[1] for f in found})
    assert names == ["graph", "static_y"]
    assert all("CUDA graph" in f.message for f in found)


def test_repo_port_lints_clean():
    """The port's library and its examples carry no findings."""
    findings = lint_paths([os.path.join(REPO, "src", "repro_torch")])
    assert findings == [], "\n".join(str(f) for f in findings)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _as_jax(text):
    return text.replace("repro_torch.analysis", "repro.analysis")


def test_lint_cli_matches_jax(tmp_path, capsys):
    """Exit 0 on clean code and 1 on findings, the same lines as the JAX
    CLI's (path:line: CODE message, then the summary)."""
    clean = tmp_path / "clean.py"
    clean.write_text(textwrap.dedent(SHARED["dmr106_fixed_read_only"]))
    bad = tmp_path / "pkg" / "bad.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(SHARED["dmr106_buggy_slice_and_del"]))
    for argv, want_rc in ((["lint", str(clean)], 0),
                          (["lint", str(tmp_path)], 1)):
        got = _run(cli.main, argv, capsys)
        ref = _run(j_cli.main, argv, capsys)
        assert got[0] == ref[0] == want_rc
        assert _as_jax(got[1]) == ref[1] and _as_jax(got[2]) == ref[2]
    assert got[1].count("DMR106") == 2
    assert got[2] == f"repro_torch.analysis lint: 2 finding(s) in " \
                     f"{tmp_path}\n"


def test_lint_cli_default_path_is_the_port(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc, out, err = _run(cli.main, ["lint"], capsys)
    assert rc == 0 and out == "repro_torch.analysis lint: clean\n", err


def test_audit_cli_on_a_cluster_trail_matches_jax(tmp_path, capsys):
    """A trail the port's live cluster dumps (six toy tenants on eight CPU
    workers, sanitized) audits clean through both CLIs, line for line; the
    same file with a device granted twice fails both, line for line."""
    specs = materialize_live("steady", n_jobs=6, max_steps=6,
                             device_count=4, seed=0)
    cl = dmr.Cluster(specs, logical_workers(8, "cpu"), policy="algorithm2",
                     sanitize=True)
    res = cl.run()
    assert res.n_resizes and len(res.records) == 6
    path = str(tmp_path / "trail.json")
    dump_trail(cl, path)
    got = _run(cli.main, ["audit", path], capsys)
    ref = _run(j_cli.main, ["audit", path], capsys)
    assert got[0] == ref[0] == 0 and got[2] == ref[2] == ""
    assert _as_jax(got[1]) == ref[1]
    assert got[1].startswith(f"repro_torch.analysis audit: {path} clean (")
    raw = json.load(open(path))
    g = next(i for i, e in enumerate(raw["trail"]) if e[0] == "grant")
    raw["trail"].insert(g + 1, raw["trail"][g])
    json.dump(raw, open(path, "w"))
    got = _run(cli.main, ["audit", path], capsys)
    ref = _run(j_cli.main, ["audit", path], capsys)
    assert got[0] == ref[0] == 1
    assert got[1] == ref[1] and "double-grant" in got[1]
    assert _as_jax(got[2]) == ref[2]
