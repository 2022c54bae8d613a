"""``qsfh_torch.config`` against ``qsfh_tpu.config``.

The same dataclasses with the same fields and defaults, and the JSON file
``save_config`` writes loads in the other package, in each direction,
with non-default values; ``LatticeConfig.half_filling`` agrees.
"""

import dataclasses

import pytest

import qsfh_tpu.config as jcfg
import qsfh_torch.config as tcfg

NAMES = ("LatticeConfig", "RunConfig", "HVAConfig", "ADAPTConfig", "IQCCConfig", "HEAConfig")


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults_match(name):
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    assert tf == jf


def _configs(mod):
    return (
        mod.LatticeConfig.half_filling(3, 3, tunneling=0.5, coulomb=4.0),
        mod.RunConfig(results_root="/tmp/r", load_model=True, degenerate_subspace=4),
        mod.HVAConfig(n_epoch=7, reps=3, lr=3e-2, early_stop=True),
        mod.ADAPTConfig(threshold1=1e-3, max_inner_iterations=40),
        mod.IQCCConfig(n_epoch=2, max_terms=500),
        mod.HEAConfig(molecule="LiH", r=1.6, seed=3),
    )


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_round_trip_across_packages(tmp_path, direction):
    src, dst = (jcfg, tcfg) if direction == "jax_to_port" else (tcfg, jcfg)
    path = str(tmp_path / "run.json")
    src.save_config(path, *_configs(src))
    loaded = dst.load_config(path, *(getattr(dst, n) for n in NAMES))
    for got, ref in zip(loaded, _configs(src)):
        assert type(got).__module__ == dst.__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert loaded[0].n_spin_up == 5 and loaded[0].n_spin_down == 4
    assert loaded[0].driver_kwargs() == dataclasses.asdict(loaded[0])
