"""The port's mesh cases of training against the reference's, the twins
of ``tests/test_distributed.py``'s pipeline / dp-tp / moe-ep / elastic
cases. The reference runs them once, in one subprocess with 8 fake host
devices (sharded for real: ``shard_map``, GSPMD); the port runs each on
a single-controller ``Mesh`` of CPU parts:
  * pipeline: ``pipeline_apply`` of a 4-stage tanh MLP over 8
    microbatches, within 1e-6 of the reference's and of the sequential
    product;
  * dp-tp: one AdamW step of yi-6b SMOKE on a (2, 4) mesh from the
    reference's params (carried by its checkpoint): loss within 1e-5
    relative, params within 1e-5 relative L2;
  * moe-ep: qwen3-moe SMOKE's loss on a (2, 4) mesh (the dispatch routes
    each data shard on its own) within 1e-5 relative;
  * elastic: a tensor saved from the reference's (2, 4) mesh, restored
    on a (4, 2) mesh, equal.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401 (autouse)
from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core.partition import Mesh
from repro_torch.data import make_batch_for
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import use_mesh
from repro_torch.pytree import leaves
from repro_torch.train import adamw, make_schedule, make_train_step

ROOT = Path(__file__).resolve().parents[1]
PIPE_ATOL = 1e-6
RTOL = 1e-5

_REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.ckpt import save_checkpoint
    from repro.configs import get_smoke_config
    from repro.data import make_batch_for
    from repro.jax_compat import make_mesh, set_mesh
    from repro.launch.mesh import make_test_mesh, mesh_axis_sizes
    from repro.models import build_model
    from repro.parallel.pipeline import pipeline_apply
    from repro.parallel.sharding import tree_shardings
    from repro.train import adamw, make_schedule

    d = sys.argv[1]
    out = {}
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    y = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws),
                       jnp.asarray(x), make_mesh((4,), ("stage",)),
                       n_microbatches=8)
    out.update(pipe_ws=ws, pipe_x=x, pipe_y=np.asarray(y))

    shape = {"global_batch": 4, "seq_len": 32}
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg)
    mesh = make_test_mesh(2, 4)
    with set_mesh(mesh):
        params = model.init(jax.random.PRNGKey(0))
        save_checkpoint(d + "/dptp", 0, params)
        sh = tree_shardings(mesh, model.param_specs(mesh_axis_sizes(mesh)))
        params = jax.tree.map(jax.device_put, params, sh)
        opt_init, opt_update = adamw(make_schedule("constant", 1e-3, 10))
        opt = opt_init(params)
        batch = make_batch_for(cfg, shape, "train")

        @jax.jit
        def step(p, o, b):
            (l, m), g = jax.value_and_grad(model.loss, has_aux=True)(p, b)
            p, o, _ = opt_update(g, o, p)
            return p, o, l

        params, opt, loss = step(params, opt, batch)
        assert "model" in str(params["layers"]["attn"]["wq"].sharding.spec)
        save_checkpoint(d + "/dptp", 1, params)
        out["dptp_loss"] = float(loss)

    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    model = build_model(cfg)
    with set_mesh(mesh):
        params = model.init(jax.random.PRNGKey(0))
        save_checkpoint(d + "/moe", 0, params)
        loss, _ = jax.jit(model.loss)(params, make_batch_for(cfg, shape,
                                                             "train"))
        out["moe_loss"] = float(loss)

    t = {"w": jnp.arange(64.0).reshape(8, 8)}
    with set_mesh(mesh):
        t1 = jax.tree.map(jax.device_put, t,
                          tree_shardings(mesh, {"w": P("data", "model")}))
        save_checkpoint(d + "/elastic", 1, t1)
    np.savez(d + "/out.npz", **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT, str(d)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return d, dict(np.load(d / "out.npz"))


def test_pipeline_matches_reference_and_sequential(reference):
    _, out = reference
    ws, x = torch.from_numpy(out["pipe_ws"]), torch.from_numpy(out["pipe_x"])
    mesh = Mesh.on("cpu", (4,), ("stage",))
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh,
                       n_microbatches=8)
    ref = x
    for i in range(4):
        ref = torch.tanh(ref @ ws[i])
    assert float((y - ref).abs().max()) < PIPE_ATOL
    assert float(np.abs(y.numpy() - out["pipe_y"]).max()) < PIPE_ATOL


def test_pipeline_stages_on_a_2d_mesh_and_bad_batch():
    """Stages along the mesh's "stage" axis (the other axis at 0); a
    batch that does not split into the microbatches raises."""
    mesh = Mesh.on("cpu", (2, 3), ("data", "stage"))
    ws = torch.randn((3, 4, 4), generator=torch.Generator().manual_seed(0))
    x = torch.randn((6, 4), generator=torch.Generator().manual_seed(1))
    y = pipeline_apply(lambda w, h: h @ w, ws, x, mesh, n_microbatches=3)
    assert torch.allclose(y, x @ ws[0] @ ws[1] @ ws[2], atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda w, h: h @ w, ws, x, mesh, n_microbatches=4)


def _restore(d, step, model):
    return restore_checkpoint(str(d), step, model.init(device="meta"),
                              device="cpu")[0]


def test_dp_tp_train_step_matches_reference(reference):
    d, out = reference
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg)
    params = _restore(d / "dptp", 0, model)
    want = _restore(d / "dptp", 1, model)
    opt_init, opt_update = adamw(make_schedule("constant", 1e-3, 10))
    step = make_train_step(model, opt_update)
    with use_mesh(make_test_mesh(2, 4, device="cpu")):
        batch = make_batch_for(cfg, {"global_batch": 4, "seq_len": 32},
                               "train", device="cpu")
        params, _, metrics = step(params, opt_init(params), batch)
    np.testing.assert_allclose(float(metrics["loss"]), out["dptp_loss"],
                               rtol=RTOL)
    a = torch.cat([t.float().ravel() for t in leaves(params)])
    b = torch.cat([t.float().ravel() for t in leaves(want)])
    assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= RTOL


def test_moe_ep_loss_matches_reference(reference):
    d, out = reference
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    model = build_model(cfg)
    params = _restore(d / "moe", 0, model)
    with use_mesh(make_test_mesh(2, 4, device="cpu")):
        loss, _ = model.loss(params, make_batch_for(
            cfg, {"global_batch": 4, "seq_len": 32}, "train", device="cpu"))
    np.testing.assert_allclose(float(loss), out["moe_loss"], rtol=RTOL)


def test_elastic_restore_on_another_mesh(reference):
    d, _ = reference
    m2 = make_test_mesh(4, 2, device="cpu")
    got, _ = restore_checkpoint(str(d / "elastic"), 1,
                                {"w": torch.zeros((8, 8))}, mesh=m2,
                                spec_tree={"w": ("data", "model")})
    assert torch.equal(got["w"], torch.arange(64.0).reshape(8, 8))
    assert got["w"].device == m2.root
