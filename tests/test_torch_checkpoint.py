"""The port's checkpoints (``repro_torch.ckpt``): the twins of
``tests/test_checkpoint.py`` (round trip, retention, atomicity, the
structure and shape guards, a restore under a mesh), and the two
packages reading each other's checkpoints bit for bit — a bf16 param
tree and an ``AdamWState`` with int8 ``QTensor`` moments."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401 (autouse)
from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.train import optimizer as RO
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.convert import (opt_state_from_arrays, opt_state_to_arrays,
                                 params_from_arrays)
from repro_torch.core.partition import Mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.pytree import leaves
from repro_torch.train.optimizer import AdamWState, QTensor


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.tensor([[1.5, -2.25], [3.0, 1e-3]],
                                    dtype=torch.bfloat16)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"data": {"step": 7}})
    got, extra = restore_checkpoint(str(tmp_path), 7, _zeros_like(t),
                                    device="cpu")
    for a, b in zip(leaves(t), leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert extra["data"]["step"] == 7
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "float32", "int32", "bfloat16"]
    assert np.load(tmp_path / "step_00000007" / "arr_2.npy").dtype == \
        np.uint16


def test_latest_and_retention(tmp_path):
    t = _tree()
    for s in (5, 10, 15, 20):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    assert latest_step(str(tmp_path)) == 20
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [15, 20]


def test_atomicity_partial_write_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp")     # a crashed mid-write
    os.makedirs(tmp_path / "step_00000008")         # no manifest
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "absent")) is None


def test_structure_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(AssertionError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros((3, 4))},
                           device="cpu")


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _zeros_like(_tree())
    bad["a"] = torch.zeros((4, 4))
    with pytest.raises(AssertionError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, bad, device="cpu")


def test_restore_with_mesh_resharding(tmp_path):
    """The elastic path: restore under a (1, 1) mesh with a spec tree;
    each leaf lands on the mesh's root device."""
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    save_checkpoint(str(tmp_path), 2, t)
    mesh = make_test_mesh(1, 1, device="cpu")
    got, _ = restore_checkpoint(str(tmp_path), 2, _zeros_like(t), mesh=mesh,
                                spec_tree={"w": ("data", "model")})
    assert torch.equal(got["w"], t["w"]) and got["w"].device == mesh.root
    with pytest.raises(ValueError, match="spec_tree"):
        restore_checkpoint(str(tmp_path), 2, _zeros_like(t), mesh=mesh,
                           spec_tree={"w": ("data",), "x": (None,)})


def test_dict_keys_are_stored_in_sorted_order(tmp_path):
    """``arr_<i>`` follows jax.tree's order (keys sorted), whatever the
    dict's insertion order."""
    t = {"z": torch.zeros(1), "a": torch.ones(2)}
    save_checkpoint(str(tmp_path), 1, t)
    assert np.load(tmp_path / "step_00000001" / "arr_0.npy").shape == (2,)


def test_tree_utilities_follow_jax_tree():
    """``repro_torch.pytree`` flattens as jax.tree does (dict keys sorted,
    NamedTuples by field, None empty), and its ``tree_map`` hands the
    other trees' subtrees at the first tree's leaves over whole."""
    from repro_torch.pytree import flatten, tree_map, unflatten
    tree = {"z": [1, (2, None)],
            "a": AdamWState(step=3, m={"w": 4, "b": 5}, v={"w": 6, "b": 7})}
    flat, treedef = flatten(tree)
    assert flat == jax.tree.leaves(tree) == [3, 5, 4, 7, 6, 1, 2]
    assert unflatten(treedef, flat) == tree
    specs = {"q": ("data", None), "p": ()}
    want = jax.tree.map(lambda a, s: (a, s), {"p": 1, "q": 2}, specs)
    assert tree_map(lambda a, s: (a, s), {"p": 1, "q": 2}, specs) == want
    with pytest.raises(ValueError):
        tree_map(lambda a, s: a, {"p": 1}, {"q": 1})
    with pytest.raises(ValueError):
        tree_map(lambda a, s: a, [1, 2], [1])


# ---- the two packages read each other's checkpoints ---------------------

def _ref_params():
    rng = np.random.default_rng(0)
    return {"embed": {"table": jnp.asarray(rng.standard_normal((16, 8)),
                                           jnp.bfloat16)},
            "layers": {"w": jnp.asarray(rng.standard_normal((2, 8, 512)),
                                        jnp.bfloat16),
                       "scale": jnp.asarray(rng.standard_normal((2, 8)),
                                            jnp.float32)},
            "final": jnp.asarray(rng.standard_normal((8,)), jnp.float32)}


def _ref_state(params):
    init, upd = RO.adamw(RO.make_schedule("constant", 1e-2, 10,
                                          warmup_steps=1),
                         quantize_moments=True)
    state = init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.1, params)
    return jax.jit(upd)(grads, state, params)[1]


def _assert_same_bits(ref_tree, port_tree):
    want = jax.tree.leaves(ref_tree)
    got = leaves(port_tree)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(w.view(np.uint16),
                                          _bits(g).view(np.uint16))
        else:
            assert str(g.dtype) == f"torch.{w.dtype}"
            np.testing.assert_array_equal(w, g.numpy())


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rp = _ref_params()
    rs = _ref_state(rp)
    params = params_from_arrays(jax.tree.map(np.asarray, rp), "cpu")
    state = opt_state_from_arrays(jax.tree.map(np.asarray, rs), "cpu")
    assert isinstance(state.m["layers"]["w"], QTensor)
    save_checkpoint(str(tmp_path), 3, (params, state),
                    extra={"data": {"step": 3, "seed": 0}})
    like = (jax.tree.map(jnp.zeros_like, rp),
            jax.tree.map(jnp.zeros_like, rs))
    got, extra = ref_restore(str(tmp_path), 3, like)
    assert extra == {"data": {"step": 3, "seed": 0}}
    assert isinstance(got[1], RO.AdamWState)
    assert isinstance(got[1].m["layers"]["w"], RO.QTensor)
    _assert_same_bits(got, (params, state))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rp = _ref_params()
    rs = _ref_state(rp)
    ref_save(str(tmp_path), 4, (rp, rs), extra={"data": {"step": 4}})
    like = (params_from_arrays(jax.tree.map(np.asarray, rp), "cpu"),
            opt_state_from_arrays(jax.tree.map(np.asarray, rs), "cpu"))
    like = jax.tree.map(torch.zeros_like, like)
    got, extra = restore_checkpoint(str(tmp_path), 4, like, device="cpu")
    assert extra == {"data": {"step": 4}}
    assert isinstance(got[1], AdamWState)
    assert isinstance(got[1].v["layers"]["w"], QTensor)
    _assert_same_bits((rp, rs), got)
    back = opt_state_to_arrays(got[1])
    assert back.step.dtype == np.int32 and back.step.shape == ()


def test_restore_on_another_mesh(tmp_path):
    """Saved from a (2, 4) mesh, restored on (4, 2): the same values, on
    the new mesh's root."""
    t = {"w": torch.arange(64.0).reshape(8, 8)}
    save_checkpoint(str(tmp_path), 1, t)
    m2 = Mesh.on("cpu", (4, 2), ("data", "model"))
    got, _ = restore_checkpoint(str(tmp_path), 1, _zeros_like(t), mesh=m2,
                                spec_tree={"w": ("data", "model")})
    assert torch.equal(got["w"], t["w"])
