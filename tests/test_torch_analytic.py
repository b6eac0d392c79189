"""``repro_torch.launch.analytic`` (the step's FLOP and HBM-traffic
model) is the reference's arithmetic over the port's configs: every
function ``==`` JAX's ``repro.launch.analytic`` for every registered
architecture at every ``INPUT_SHAPES`` entry; and ``launch.mesh``'s
helpers are the reference's."""
import pytest

from repro.configs import base as jcfgs
from repro.launch import analytic as janalytic
from repro.launch import mesh as jmesh
from repro_torch.configs import base as cfgs
from repro_torch.launch import analytic, mesh

PAIRS = [(a, s) for a in sorted(cfgs.names()) for s in cfgs.INPUT_SHAPES]


def test_the_registries_agree():
    assert sorted(cfgs.names()) == sorted(jcfgs.names())
    assert list(cfgs.INPUT_SHAPES) == list(jcfgs.INPUT_SHAPES)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_analytic_matches_jax(arch, shape):
    cfg, jcfg = cfgs.get(arch), jcfgs.get(arch)
    s, js = cfgs.INPUT_SHAPES[shape], jcfgs.INPUT_SHAPES[shape]
    assert analytic._unit_counts(cfg) == janalytic._unit_counts(jcfg)
    for decode in (False, True):
        assert analytic.forward_flops(cfg, s, decode) \
            == janalytic.forward_flops(jcfg, js, decode)
    assert analytic.step_flops(cfg, s) == janalytic.step_flops(jcfg, js)
    assert analytic.model_flops(cfg, s) == janalytic.model_flops(jcfg, js)
    for devices in (1, 256, 512):
        for eightbit in (False, True):
            assert analytic.hbm_bytes_per_device(
                cfg, s, devices, eightbit_opt=eightbit) \
                == janalytic.hbm_bytes_per_device(
                    jcfg, js, devices, eightbit_opt=eightbit)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_helpers_match_jax(multi_pod):
    assert mesh.data_axes(multi_pod) == jmesh.data_axes(multi_pod)
    assert mesh.n_chips(multi_pod) == jmesh.n_chips(multi_pod)


def test_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh(device="cpu")
