"""The port's restartable trainer (``repro_torch.ft.elastic``) and
training launcher (``repro_torch.launch.train``): the twins of
``tests/test_ft_data.py``'s trainer tests and of ``tests/test_system.py``'s
three training cases, run with ``--device cpu``, and the launcher's lr
column against the reference launcher's on the same flags."""
import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401 (autouse)
from repro_torch.data import SyntheticLMDataset
from repro_torch.ft import FailAt, RestartableTrainer
from repro_torch.launch.train import main


def _ds():
    return SyntheticLMDataset(vocab=10, seq_len=8, global_batch=1,
                              device="cpu")


def test_restartable_trainer_resumes(tmp_path):
    calls = {"n": 0}

    def init_state():
        return {"w": torch.zeros((3,))}

    def step_fn(state, step):
        calls["n"] += 1
        return {"w": state["w"] + 1.0}, {"loss": float(10 - step)}

    ds = _ds()
    tr = RestartableTrainer(str(tmp_path), ckpt_every=4, max_restarts=2,
                            device="cpu")
    report = tr.run(init_state=init_state, step_fn=step_fn,
                    data_state=ds.state, restore_data=ds.restore,
                    total_steps=10, fail_at=6)
    assert report["completed"]
    assert report["restarts"] == 1
    # steps 0..5 ran, failed at 6 (before executing), resumed from ckpt 4:
    # re-ran 4..9 → total executed = 6 + 6 = 12
    assert calls["n"] == 12
    assert [h["step"] for h in report["history"]] == \
        list(range(6)) + list(range(4, 10))


def test_restartable_trainer_gives_up(tmp_path):
    def init_state():
        return {"w": torch.zeros(())}

    def step_fn(state, step):
        raise FailAt("always")

    ds = _ds()
    tr = RestartableTrainer(str(tmp_path) + "/x", ckpt_every=100,
                            max_restarts=1, device="cpu")
    report = tr.run(init_state=init_state, step_fn=step_fn,
                    data_state=ds.state, restore_data=ds.restore,
                    total_steps=3, fail_at=None)
    assert not report["completed"]
    assert report["restarts"] == 2      # initial failure + 1 allowed restart


def test_train_launcher_with_failure_injection(tmp_path):
    report = main(["--arch", "minicpm-2b", "--smoke", "--steps", "12",
                   "--batch", "4", "--seq", "64",
                   "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                   "--simulate-failure", "7", "--device", "cpu"])
    assert report["completed"]
    assert report["restarts"] == 1
    losses = [h["loss"] for h in report["history"]]
    assert losses[-1] < losses[0]
    assert sorted(int(d.name[5:]) for d in tmp_path.iterdir()) == [5, 10, 12]


def test_train_launcher_quantized_optimizer():
    report = main(["--arch", "yi-6b", "--smoke", "--steps", "6",
                   "--batch", "4", "--seq", "64",
                   "--quantized-optimizer", "--device", "cpu"])
    assert report["completed"]
    assert all(np.isfinite(h["loss"]) for h in report["history"])


def test_wsd_schedule_used_for_minicpm_and_lr_equals_reference():
    """The MiniCPM arch trains with its published WSD schedule; the lr
    column equals the reference launcher's on the same flags — its
    ``make_schedule("wsd", --lr, --steps)`` at steps 1 .. 10
    (``repro/launch/train.py:61-63``, read by its AdamW at each step)."""
    import jax.numpy as jnp
    from repro.train import make_schedule as ref_make_schedule
    report = main(["--arch", "minicpm-2b", "--smoke", "--steps", "10",
                   "--batch", "2", "--seq", "32", "--device", "cpu"])
    lrs = [h["lr"] for h in report["history"]]
    assert lrs[1] >= lrs[0]
    sched = ref_make_schedule("wsd", 3e-3, 10)
    want = [float(sched(jnp.asarray(s, jnp.int32))) for s in range(1, 11)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=0)


def test_train_launcher_writes_its_log(tmp_path):
    log = tmp_path / "m.jsonl"
    report = main(["--arch", "mamba2-780m", "--smoke", "--steps", "2",
                   "--batch", "2", "--seq", "32", "--grad-accum", "2",
                   "--log", str(log), "--device", "cpu"])
    rows = log.read_text().splitlines()
    assert len(rows) == len(report["history"]) == 2
    assert '"grad_norm"' in rows[0]


@pytest.mark.parametrize("flag", [["--data-parallel", "2"],
                                  ["--model-parallel", "2"]])
def test_train_launcher_on_a_test_mesh(flag):
    """The MoE dispatch reads the mesh's data axis; the run stays finite
    under either axis."""
    report = main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--steps", "2",
                   "--batch", "4", "--seq", "32", "--device", "cpu"] + flag)
    assert all(np.isfinite(h["loss"]) for h in report["history"])


def test_make_serve_step_gives_prefill_and_decode():
    """``make_serve_step`` returns the model's prefill and decode step,
    run without autograd; an unknown kind raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step
    model = build_model(get_smoke_config("yi-6b"))
    params = model.init(0, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    prefill, decode = make_serve_step(model, "prefill"), make_serve_step(
        model, "decode")
    lg, cache = prefill(params, {"tokens": tokens}, cache_len=10)
    want, _ = model.prefill(params, {"tokens": tokens}, cache_len=10)
    assert torch.equal(lg, want) and not lg.requires_grad
    lg2, cache2 = decode(params, cache, {"tokens": tokens[:, :1]})
    assert lg2.shape == (2, 1, lg.shape[-1]) and int(cache2["len"]) == 9
    with pytest.raises(ValueError):
        make_serve_step(model, "train")
