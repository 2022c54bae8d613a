"""The port's CLI (``qsfh_torch.cli``) against the JAX CLI (``qsfh_tpu.cli``).

Each subcommand runs through ``qsfh_torch.cli.main([..., "--device",
"cpu", "--x64"])`` and ``qsfh_tpu.cli.main([..., "--platform", "cpu",
"--x64"])`` in separate working directories and results roots (no shared
ED cache), at the sizes ``tests/test_cli.py`` uses: the printed results
and the JSON files each writes agree within 1e-8 (the drivers' own parity
is 1e-9; a printed number within one unit of its last printed digit).
This file holds the analysis subcommands (ed, symmetry, spectral,
dynamics, ite) and the parser; ``test_torch_cli_drivers.py`` the training
drivers.  Also: the two argparse trees have the same subcommands, options
and defaults apart from the deviations (``--platform`` -> ``--device``, and
the port's ``--dist-backend``);
an unknown molecule exits; the multistart ``--molecule`` warnings are the
JAX CLI's; hva's, adapt's and multistart's ``--mesh-devices 2`` run on two
gloo ranks as the API run does; the default
device raises without a card; ``python -m qsfh_torch.cli`` runs with JAX
blocked.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import qsfh_tpu.cli as jcli
import qsfh_torch.cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+(?:e[-+]\d+)?")


@pytest.fixture(autouse=True)
def _own_solves(monkeypatch):
    """Each package solves its own ground state (no shared ED cache), on
    one intra-op thread (several pytest workers share the cores)."""
    monkeypatch.delenv("QSFH_ED_CACHE_DIR", raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def run_both(argv, tmp_path, capsys, monkeypatch):
    """{"jax": (stdout, files), "torch": (stdout, files)}: each CLI in its
    own working directory, ``files`` the JSON it wrote there (relative
    path -> parsed)."""
    out = {}
    for name, main, extra in (("jax", jcli.main, ["--platform", "cpu", "--x64"]),
                              ("torch", tcli.main, ["--device", "cpu", "--x64"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        main(argv + extra + ["--results-root", str(work / "results")])
        files = {}
        for dirpath, _, names in os.walk(work):
            for f in names:
                if f.endswith(".json"):
                    path = os.path.join(dirpath, f)
                    with open(path) as fh:
                        files[os.path.relpath(path, work)] = json.load(fh)
        out[name] = (capsys.readouterr().out, files)
    return out


def assert_close(got, ref, path="$"):
    """Recursive comparison of parsed JSON: numbers within TOL (relative
    to max(1, |ref|)), everything else equal."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            assert_close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{path}[{i}]")
    elif isinstance(ref, (int, float)) and not isinstance(ref, bool) and ref is not None:
        assert abs(float(got) - float(ref)) <= TOL * max(1.0, abs(float(ref))), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def assert_printed_close(got: str, ref: str):
    """Two printed lines with the same words and numbers that agree within
    TOL or one unit of the last printed digit."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", ref), (got, ref)
    for g, r in zip(NUMBER.findall(got), NUMBER.findall(ref)):
        mant = r.split("e")[0]
        digits = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(r.split("e")[1]) if "e" in r else 0
        unit = 10.0 ** (exp - digits)
        assert abs(float(g) - float(r)) <= max(TOL * max(1.0, abs(float(r))), unit * 1.0001), (
            got, ref)


def _json_blob(stdout: str):
    return json.loads(stdout[stdout.index("{"):])


LATTICE_2X2 = ["--x-dimension", "2", "--y-dimension", "2"]


@pytest.mark.parametrize("extra", [[], ["--x-dimension", "4", "--y-dimension", "1",
                                        "--n-electrons", "3", "--n-spin-up", "2",
                                        "--n-spin-down", "1", "--degenerate-subspace", "2"]],
                         ids=["2x2", "1x4_degenerate"])
def test_ed_matches_jax(tmp_path, capsys, monkeypatch, extra):
    res = run_both(["ed"] + LATTICE_2X2 + extra, tmp_path, capsys, monkeypatch)
    (tout, _), (jout, _) = res["torch"], res["jax"]
    tline = [s for s in tout.splitlines() if s.startswith("ground energy")]
    jline = [s for s in jout.splitlines() if s.startswith("ground energy")]
    assert len(tline) == len(jline) == 1
    assert_printed_close(tline[0], jline[0])
    if not extra:
        assert "-1.6346" in tline[0]


def test_symmetry_matches_jax(tmp_path, capsys, monkeypatch):
    res = run_both(["symmetry"] + LATTICE_2X2, tmp_path, capsys, monkeypatch)
    got, ref = _json_blob(res["torch"][0]), _json_blob(res["jax"][0])
    assert_close(got, ref)
    assert got["c4_irrep_norms"]["d"] == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("kind", ["particle", "spin"])
def test_spectral_matches_jax(tmp_path, capsys, monkeypatch, kind):
    argv = ["spectral"] + LATTICE_2X2 + ["--kind", kind, "--kx", "1", "--ky", "1", "--m", "40"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    got, ref = _json_blob(res["torch"][0]), _json_blob(res["jax"][0])
    assert_close(got, ref)
    assert_close(res["torch"][1], res["jax"][1])
    assert set(res["torch"][1]) == {"spectral.json"}
    assert len(res["torch"][1]["spectral.json"]["A"]) == 201


def test_dynamics_matches_jax(tmp_path, capsys, monkeypatch):
    argv = ["dynamics"] + LATTICE_2X2 + ["--coulomb", "4", "--dt", "0.05", "--t-final", "0.5",
                                         "--initial", "neel"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    tl, jl = res["torch"][0].splitlines(), res["jax"][0].splitlines()
    assert_close(json.loads(tl[-2]), json.loads(jl[-2]))
    assert tl[-1] == jl[-1] == "wrote dynamics.json (10 steps)"
    assert_close(res["torch"][1], res["jax"][1])


def test_dynamics_ramp_and_slater_match_jax(tmp_path, capsys, monkeypatch):
    argv = ["dynamics"] + LATTICE_2X2 + ["--coulomb", "4", "--dt", "0.1", "--t-final", "0.3",
                                         "--u-final", "2"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    assert_close(res["torch"][1], res["jax"][1])


def test_neel_rejects_other_sectors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="half filling"):
        tcli.main(["dynamics", "--n-electrons", "2", "--initial", "neel", "--device", "cpu"])


def test_ite_matches_jax(tmp_path, capsys, monkeypatch):
    argv = ["ite"] + LATTICE_2X2 + ["--dbeta", "0.05", "--order", "6", "--n-steps", "100",
                                    "--initial", "neel"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    got, ref = json.loads(res["torch"][0].splitlines()[-1]), json.loads(
        res["jax"][0].splitlines()[-1])
    assert_close(got, ref)
    assert res["torch"][1]["ite.json"] == got
    assert_close(res["torch"][1], res["jax"][1])


# -- the parser ---------------------------------------------------------------------------


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, taken where ``main`` parses its arguments."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        jcli.main(["ed"])
    monkeypatch.undo()
    return seen["parser"]


def _tree(parser, drop):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    tree = {}
    for name, p in sub.choices.items():
        tree[name] = {
            a.option_strings[0]: (a.default, tuple(a.choices or ()), a.type, type(a).__name__,
                                  a.nargs)
            for a in p._actions
            if a.option_strings and a.option_strings[0] not in ("-h",) + drop
        }
    return tree


def test_argparse_trees_match_apart_from_the_deviations(monkeypatch):
    jtree = _tree(_jax_parser(monkeypatch), ("--platform",))
    ttree = _tree(tcli.build_parser()[0], ("--device", "--dist-backend"))
    assert list(ttree) == list(jtree)
    for name in jtree:
        assert ttree[name] == jtree[name], name
    device = {a.option_strings[0]: a for a in
              tcli.build_parser()[0]._subparsers._group_actions[0].choices["ed"]._actions
              if a.option_strings}["--device"]
    assert device.default == "cuda" and tuple(device.choices) == ("cuda", "cpu")


def test_unknown_molecule_exits():
    with pytest.raises(SystemExit, match="unknown molecule"):
        tcli.main(["hea", "--molecule", "Unobtainium", "--device", "cpu"])


MESH_ARGV = {
    "hva": ["--n-epoch", "3", "--reps", "1"],
    "adapt": ["--n-epoch", "1", "--max-inner-iterations", "3", "--threshold2", "1e-1"],
    "multistart": ["--n-starts", "4", "--n-epoch", "3", "--reps", "1"],
}


def _api_run(command, argv, root):
    """The results of the same run through the Python API, on one process."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.algos.hva import HVA
    from qsfh_torch.algos.multistart import MultistartHVA

    args = tcli.build_parser()[0].parse_args([command] + argv)
    if command == "multistart":
        return MultistartHVA(n_starts=args.n_starts, n_epoch=args.n_epoch, reps=args.reps,
                             lr=args.lr, init_scale=args.init_scale, seed=args.seed,
                             results_root=root, dtype=torch.complex128, device="cpu",
                             **tcli._lattice_kwargs(args)).run()
    common = dict(load_model=False, degenerate_subspace=0, results_root=root, plot=False,
                  dtype=torch.complex128, device="cpu", **tcli._lattice_kwargs(args))
    if command == "hva":
        return HVA(n_epoch=args.n_epoch, reps=args.reps, lr=args.lr, threshold=args.threshold,
                   early_stop=False, **common).run()
    return ADAPT(n_epoch=args.n_epoch, threshold1=args.threshold1, threshold2=args.threshold2,
                 max_inner_iterations=args.max_inner_iterations, **common).run()


@pytest.mark.parametrize("command", ["hva", "adapt", "multistart"])
def test_mesh_devices_above_one_run_on_gloo_ranks(command, tmp_path, monkeypatch, capfd):
    """hva, adapt and multistart with --mesh-devices 2 --dist-backend gloo
    run on two gloo ranks: hva and adapt write, and multistart (its start
    axis) returns and prints once, what the same run through the API gives
    (1e-9)."""
    monkeypatch.chdir(tmp_path)
    if command == "multistart":
        argv = MESH_ARGV[command] + ["--x64", "--results-root", str(tmp_path / "mesh")]
        got = tcli.main([command, "--mesh-devices", "2", "--dist-backend", "gloo", "--device",
                         "cpu"] + argv)
        out = capfd.readouterr().out
        ref = _api_run(command, argv, str(tmp_path / "api"))
        assert out.count("multistart: 4 starts x 3 epochs") == 1
        assert got["best_index"] == ref["best_index"]
        for key in ("energies", "final_energies", "best_energy", "best_gap"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-9, err_msg=key)
        for key, values in ref["best_params"].items():
            np.testing.assert_allclose(got["best_params"][key], values, rtol=0, atol=1e-9)
        with pytest.raises(SystemExit, match="must divide"):
            tcli.main([command, "--mesh-devices", "3", "--device", "cpu"] + argv)
        return
    argv = MESH_ARGV[command] + ["--no-plot", "--x64"]
    tcli.main([command, "--mesh-devices", "2", "--dist-backend", "gloo", "--device", "cpu",
               "--results-root", str(tmp_path / "mesh")] + argv)
    ref = _api_run(command, argv, str(tmp_path / "api"))
    (path,) = (tmp_path / "mesh" / "vqe_results").glob("*.json")
    got = json.loads(path.read_text())
    assert sorted(got) == sorted(ref)
    for key, values in ref.items():
        if key == "selected operators":
            assert got[key] == values
        else:
            np.testing.assert_allclose(got[key], values, rtol=0, atol=1e-9, err_msg=key)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["ed"])


class _FakeMultistart:
    def __init__(self, *a, **k):
        pass

    def run(self):
        return {"best_index": 0, "best_energy": -1.0, "final_energies": np.array([-1.0])}


@pytest.mark.parametrize("extra", [["--x-dimension", "3"], ["--init-scale", "0.5"], []],
                         ids=["lattice_flag", "init_scale", "defaults"])
def test_multistart_molecule_warnings_match_jax(tmp_path, monkeypatch, capsys, extra):
    import qsfh_tpu.algos.multistart as jms
    import qsfh_torch.algos.multistart as tms

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jms, "MultistartHEA", _FakeMultistart)
    monkeypatch.setattr(tms, "MultistartHEA", _FakeMultistart)
    argv = ["multistart", "--molecule", "H2", "--n-starts", "1", "--n-epoch", "1"] + extra
    messages = {}
    for name, main, dev in (("jax", jcli.main, ["--platform", "cpu"]),
                            ("torch", tcli.main, ["--device", "cpu"])):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            main(argv + dev)
        messages[name] = [str(w.message) for w in caught if "HVA-only flags" in str(w.message)]
    assert messages["torch"] == messages["jax"]
    assert bool(messages["torch"]) == bool(extra)
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]


def test_module_entry_point_runs_with_jax_blocked(tmp_path):
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['qsfh_torch.cli', 'ed', '--device', 'cpu', '--x64', '--results-root', "
        f"{str(tmp_path / 'results')!r}]\n"
        "runpy.run_module('qsfh_torch.cli', run_name='__main__')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'qsfh_tpu']\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("QSFH_ED_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ground energy: -1.6346")
