"""The port's sharding vocabulary (``parallel/sharding.py``) against the
reference's: ``spec_for_mesh`` / ``_filter_entry`` over every entry
kind, ``mesh_axis_size`` under ``use_mesh``, ``constrain`` the
identity; and the MoE dispatch under an active mesh routes each data
shard on its own, as the reference's does."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.parallel import sharding as RS
from repro_torch.configs import get_smoke_config
from repro_torch.core.partition import Mesh
from repro_torch.models import moe as TM
from repro_torch.parallel import sharding as TS

SPECS = [(), (None,), ("data",), ("model", None), (("pod", "data"), None),
         (None, ("pod", "data"), None, "model", None),
         (("pod", "model"), "data"), (("x", "y"), "z")]
AXES = [("data",), ("data", "model"), ("pod", "data", "model"), ("model",),
        ("graph",)]


@pytest.mark.parametrize("names", AXES, ids="-".join)
def test_spec_for_mesh_equals_reference(names):
    mesh = Mesh.on("cpu", (1,) * len(names), names)
    for spec in SPECS:
        want = tuple(RS.spec_for_mesh(RS.P(*spec),
                                      SimpleNamespace(axis_names=names)))
        assert TS.spec_for_mesh(spec, mesh) == want, (names, spec)
        for entry in spec:
            assert TS._filter_entry(entry, names) == \
                RS._filter_entry(entry, names)


def test_no_active_mesh():
    assert TS.active_mesh() is None
    assert TS.spec_for_mesh(("data", "model")) == ()
    assert TS.mesh_axis_size("model") == 1
    x = torch.ones(3)
    assert TS.constrain(x, "data") is x


def test_use_mesh_sets_the_axis_sizes():
    mesh = Mesh.on("cpu", (2, 4), ("data", "model"))
    with TS.use_mesh(mesh):
        assert TS.active_mesh() is mesh
        assert TS.mesh_axis_size("data") == 2
        assert TS.mesh_axis_size("model") == 4
        assert TS.mesh_axis_size("pod") == 1
        assert TS.spec_for_mesh((("pod", "data"), None)) == ("data", None)
        assert TM._num_data_shards() == 2
    assert TS.active_mesh() is None
    assert TM._num_data_shards() == 1


def test_moe_routes_each_data_shard_on_its_own():
    """Under a data axis of 2 the token stream splits in two halves, each
    routed with its own capacity: the output equals each half through
    moe_ffn alone, and an odd token count falls back to one shard."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(
        capacity_factor=0.1)
    params = TM.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32))
    with TS.use_mesh(Mesh.on("cpu", (2,), ("data",))):
        y, aux = TM.moe_ffn(params, x, cfg)
        y_odd, _ = TM.moe_ffn(params, x[:1, :3], cfg)
    halves = [TM.moe_ffn(params, h, cfg)[0] for h in (x[:2], x[2:])]
    assert torch.equal(y, torch.cat(halves))
    assert torch.equal(y_odd, TM.moe_ffn(params, x[:1, :3], cfg)[0])
    assert 0.0 < float(aux["moe_drop_frac"]) < 1.0
