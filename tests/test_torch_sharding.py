"""The port's logical-axis sharding against the reference's
(``repro/models/sharding.py``): ``spec_for``, ``fsdp_extend`` (with and
without ``prefer_stack``), ``defs_to_specs`` and ``donor_extend`` equal the
reference's entry for entry over every architecture's full-config param
defs, on the (16, 16) ``data``/``model``, (2, 16, 16) ``pod``/``data``/
``model``, (2, 2, 2) and (1,) meshes and under a rules overlay; the shard
shapes :func:`local_shape` gives are the reference's
``NamedSharding.shard_shape``; a hypothesis case mirrors
``tests/test_sharding.py::test_always_divisible``; :class:`Runtime.specs`
is None without a mesh.  The reference needs only ``dict(mesh.shape)``, so
JAX's ``AbstractMesh`` stands for its meshes (no devices) and a mapping
for the port's.
"""

import jax
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jax_get_config
from repro.models import sharding as jsh
from repro.models.model_zoo import ModelBundle as JaxBundle
from repro_torch.api import Runtime
from repro_torch.configs import get_config
from repro_torch.core.placement import Role
from repro_torch.models import sharding as sh
from repro_torch.models.model_zoo import ModelBundle

ARCHS = ["granite-8b", "yi-6b", "olmo-1b", "gemma3-27b", "mamba2-780m", "zamba2-1.2b",
         "llama4-maverick-400b-a17b", "deepseek-v2-236b", "internvl2-1b",
         "seamless-m4t-medium"]
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "1": ((1,), ("data",)),
}
#: (label, the keyword arguments of defs_to_specs)
VARIANTS = [
    ("rules", {}),
    ("overlay", {"rules": {"seq": ("model",)}}),
    ("fsdp", {"fsdp_axes": ("data",)}),
    ("donor", {"fsdp_axes": ("data",), "donor_axes": ("pod",)}),
    ("donor_stack", {"donor_axes": ("data",), "donor_prefer_stack": True}),
]


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), dict(zip(axes, sizes))


@pytest.fixture(scope="module")
def defs():
    """Each architecture's full-config param defs, in both packages."""
    return {a: (ModelBundle(get_config(a)).param_defs(),
                JaxBundle(jax_get_config(a)).param_defs()) for a in ARCHS}


def _ref_specs(tree):
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda x: isinstance(x, NamedSharding))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("variant", [v for v, _ in VARIANTS])
def test_defs_to_specs_equal_the_reference(defs, mesh_name, variant):
    jmesh, mesh = _meshes(mesh_name)
    kw = dict(VARIANTS)[variant]
    if any(a not in mesh for a in kw.get("donor_axes", ())):
        kw = {**kw, "donor_axes": ("data",)}
    for arch in ARCHS:
        ours, theirs = defs[arch]
        got = sh.tree_map(tuple, sh.defs_to_specs(ours, mesh, **kw))
        want = _ref_specs(jsh.defs_to_specs(theirs, jmesh, **kw))
        assert got == want, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_for_fsdp_extend_and_local_shape_per_leaf(defs, mesh_name):
    """Leaf by leaf: spec_for, fsdp_extend both ways, donor_extend, and the
    shard shape of the result."""
    jmesh, mesh = _meshes(mesh_name)
    n = 0
    for arch in ARCHS:
        for p in sh.tree_leaves(defs[arch][0]):
            spec = sh.spec_for(p.shape, p.axes, mesh)
            assert tuple(spec) == tuple(jsh.spec_for(p.shape, p.axes, jmesh))
            for stack in (False, True):
                got = sh.fsdp_extend(spec, p.shape, mesh, ("data",), p.axes, stack)
                want = jsh.fsdp_extend(jsh.P(*spec), p.shape, jmesh, ("data",), p.axes, stack)
                assert tuple(got) == tuple(want), (arch, p)
                assert tuple(sh.donor_extend(spec, p.shape, mesh, ("data",), p.axes, stack)) \
                    == tuple(jsh.donor_extend(jsh.P(*spec), p.shape, jmesh, ("data",),
                                              p.axes, stack))
                assert sh.local_shape(p.shape, got, mesh) == tuple(
                    NamedSharding(jmesh, want).shard_shape(p.shape))
                n += 1
            assert sh.spec_axes(spec) == jsh.spec_axes(jsh.P(*spec))
    assert n > 500


@given(st.lists(st.sampled_from([4, 8, 12, 16, 64, 6, 10]), min_size=1, max_size=4))
@settings(max_examples=50, deadline=None)
def test_always_divisible(dims):
    mesh = {"data": 4, "model": 4}
    axes = ["heads", "d_ff", "batch", "vocab"][: len(dims)]
    spec = sh.spec_for(tuple(dims), tuple(axes), mesh)
    assert tuple(spec) == tuple(jsh.spec_for(tuple(dims), tuple(axes),
                                             AbstractMesh((4, 4), ("data", "model"))))
    for dim, entry in zip(dims, spec):
        total = 1
        for a in sh.entry_axes(entry):
            total *= mesh[a]
        assert dim % total == 0
    assert sh.local_shape(dims, spec, mesh)


def test_use_sharding_overlays_the_default_rules():
    assert sh.current_mesh() is None and sh.current_rules() == sh.DEFAULT_RULES
    with sh.use_sharding({"model": 4}, {"seq": ["model"]}):
        assert sh.current_rules()["seq"] == ("model",)
        assert sh.current_rules()["heads"] == ("model",)
        assert sh.spec_for((8, 16), ("seq", "heads")) == sh.P("model")
    assert sh.current_mesh() is None and sh.current_rules() == sh.DEFAULT_RULES
    assert sh.spec_for((8,), ("heads",)) == sh.P()
    # a spec is a leaf of the port's trees
    assert sh.tree_leaves({"a": [sh.P("data", None), sh.P()]}) == [sh.P("data", None), sh.P()]


def test_runtime_specs():
    bundle = ModelBundle(get_config("granite-8b"))
    assert Runtime(bundle, "cpu").specs(Role.PARAMS) is None
    mesh = {"data": 16, "model": 16}
    rt = Runtime(bundle, "cpu", mesh=mesh, rules={"seq": ("model",)})
    assert rt.rules["seq"] == ("model",) and rt.rules["heads"] == ("model",)
    assert rt.describe()["mesh_axes"] == mesh
    defs = bundle.param_defs()
    assert rt.specs(Role.PARAMS, fsdp_axes=("data",)) == sh.defs_to_specs(
        defs, mesh, {"seq": ("model",)}, fsdp_axes=("data",))
    with pytest.raises(ValueError, match="def pytree"):
        rt.specs(Role.OPT_STATE)
