"""The port's dry-run (``repro_torch.launch.dryrun``) and its sharding
fit (``parallel.sharding.fit_sharding``) against the reference's:
``parse_collectives`` on ``tests/test_system.py``'s HLO, the probe
layer counts and the extrapolation arithmetic, the fitted specs of every
full config's params and int8 moments on both production meshes, and a
meta-device cell end to end."""
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from _torch_train import one_thread  # noqa: F401 (autouse)
from repro.configs import get_config as ref_get_config
from repro.parallel import sharding as RS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     mesh_axis_sizes)
from repro_torch.models import build_model
from repro_torch.parallel.sharding import (NamedSharding, fit_sharding,
                                           is_spec, tree_shardings)
from repro_torch.pytree import leaves
from repro_torch.train.optimizer import adamw, make_schedule

HLO = """
  %all-gather.67 = f32[4096,128]{1,0} all-gather(%x), replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %all-reduce.1 = f32[8,128]{1,0} all-reduce(%dot), channel_id=1, replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %rs = bf16[128]{0} reduce-scatter(%y), replica_groups=[4,2]<=[2,4]T(1,0), dimensions={0}
  %cp = f32[64]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %ars = (f32[16]{0}, bf16[4,4]{1,0}) all-reduce-start(%a, %b), replica_groups={{0,1}}
  %a2a = s8[32,2]{1,0} all-to-all(%q), replica_groups=[2,4]<=[8]
  %add.3 = f32[8]{0} add(%p, %q)
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module. It sets XLA_FLAGS (512 host
    devices) when imported: the backend is started first, so this
    process keeps its devices, and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as RD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return RD


def test_parse_collectives_equals_reference(ref_dryrun):
    got = D.parse_collectives(HLO)
    assert got == ref_dryrun.parse_collectives(HLO)
    per = got["per_op"]
    assert per["all-gather"]["bytes"] == 4096 * 128 * 4
    # the tuple-shaped all-reduce-start matches neither side's pattern
    assert per["all-reduce"]["count"] == 1
    assert per["all-to-all"]["bytes"] == 64
    assert per["reduce-scatter"]["link_bytes"] == 128 * 2 * 2
    assert D.DTYPE_BYTES == ref_dryrun.DTYPE_BYTES
    assert D.QUANT_OPT_ARCHS == ref_dryrun.QUANT_OPT_ARCHS
    assert D.GRAD_ACCUM == ref_dryrun.GRAD_ACCUM


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_layers_and_extrapolation_match_reference(ref_dryrun, arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert D._probe_layers(cfg) == ref_dryrun._probe_layers(rcfg)
    k1, k2, units = D._probe_layers(cfg)
    for c1, c2 in ((110.0, 210.0), (5e12, 4e12), (0.0, 7.5)):
        est = D.extrapolate(cfg, {"flops": c1}, {"flops": c2})
        # the reference's loop in dryrun_cell, on the same counts
        per_unit_k = (k2 - k1) / (1 if rcfg.family != "hybrid"
                                  else rcfg.attn_every)
        n1 = k1 if rcfg.family != "hybrid" else 1
        marginal = max(c2 - c1, 0.0) / per_unit_k
        fixed = max(c1 - n1 * marginal, 0.0)
        assert est["flops"] == fixed + units * marginal
        assert (est["flops_marginal"], est["flops_fixed"]) == (marginal, fixed)
        assert est["probe_k"] == (k1, k2, units)
    small = D._with_layers(cfg, k1)
    assert small.n_layers == k1
    if cfg.family == "encdec":
        assert small.n_enc_layers == small.n_dec_layers == k1


def test_probe_arithmetic_reconstructs_a_deeper_count():
    """fixed + units × marginal from the 1- and 2-layer probes equals the
    FLOPs counted directly at 4 layers (a dense arch is linear in its
    depth)."""
    cfg = get_config("minicpm-2b")
    shape = {"global_batch": 2, "seq_len": 64}
    c = [D.step_flops(D._with_layers(cfg, k), shape, "train", False)
         for k in (1, 2, 4)]
    est = D.extrapolate(cfg.replace(n_layers=4), {"flops": c[0]},
                        {"flops": c[1]})
    assert est["flops"] == pytest.approx(c[2], rel=1e-12)
    assert est["flops_marginal"] > 0


def _fake_ref_mesh(mesh):
    return SimpleNamespace(axis_names=mesh.axis_names,
                           devices=np.empty(mesh.shape))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_fit_sharding_equals_reference_on_every_full_config(monkeypatch,
                                                            multi_pod):
    """Every param's and every int8 moment's (codes and scale) fitted
    spec equals the reference's ``fit_sharding`` on the same shape and
    spec; the reference's returns its spec bare here (NamedSharding
    needs real devices)."""
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rmesh = _fake_ref_mesh(mesh)
    init, _ = adamw(make_schedule("constant", 1e-3, 10),
                    quantize_moments=True)
    n = 0
    for arch in ARCH_IDS:
        model = build_model(get_config(arch))
        params = model.init(device="meta")
        specs = leaves(model.param_specs(mesh_axis_sizes(mesh)), is_spec)
        moments = init(params).m
        for p, spec, mom in zip(leaves(params), specs,
                                leaves(moments, lambda x: hasattr(
                                    x, "codes"))):
            for t in ([p] + ([mom.codes, mom.scale]
                             if hasattr(mom, "codes") else [])):
                got = fit_sharding(mesh, tuple(t.shape), spec)
                want = RS.fit_sharding(rmesh, tuple(t.shape), RS.P(*spec))
                assert got.spec == tuple(want), (arch, spec, t.shape)
                n += 1
    assert n > 200


def test_sharding_records():
    mesh = make_test_mesh(2, 4, device="cpu")
    s = fit_sharding(mesh, (6, 8), ("data", "model"))
    assert s == NamedSharding(mesh, ("data", "model"))
    assert s.shard_shape((6, 8)) == (3, 2) and s.device == mesh.root
    assert fit_sharding(mesh, (5, 8), (("data", "model"), None)).spec == \
        (None, None)
    tree = tree_shardings(mesh, {"a": ("data",), "b": [(None, "model"), ()]})
    assert tree["a"].spec == ("data",) and tree["b"][1].spec == ()
    assert make_production_mesh().devices[0].type == "meta"
    assert mesh_axis_sizes(make_production_mesh(multi_pod=True)) == {
        "pod": 2, "data": 16, "model": 16}


def test_dryrun_cell_on_meta(tmp_path):
    out = tmp_path / "d.json"
    rows = D.main(["--arch", "minicpm-2b", "--shape", "train_4k",
                   "--multi-pod", "both", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["failures"] == [] and len(saved["rows"]) == len(rows) == 2
    one, two = rows
    assert one["chips"] == 256 and two["chips"] == 512
    mem = one["memory"]
    assert mem["state_per_device"] == (mem["param_bytes"] + mem["grad_bytes"]
                                       + mem["opt_bytes"])
    assert mem["grad_bytes"] > mem["param_bytes"]       # accum 4: fp32 sums
    est = one["est"]
    assert est["flops"] == two["est"]["flops"] > one["model_flops_global"]
    assert est["flops_per_device"] == est["flops"] / 256
