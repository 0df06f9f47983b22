"""The port's serving driver against the reference's
(``repro.launch.serve``): the CLI twin of
``tests/test_system.py::test_serve_driver``, and the same arch, params
and arguments served by both, the same ids out."""
import re

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as RS
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.launch import serve as TS
from repro_torch.models import build_model

ARGS = ["--smoke", "--requests", "4", "--batch", "2", "--prompt-len", "16",
        "--gen-len", "8"]
SAMPLE = re.compile(r"sample output ids: (\[[0-9, ]*\])")


def test_serve_driver(capsys):
    report = TS.main(["--arch", "minicpm-2b", *ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 requests" in out and "32 tokens in" in out
    assert report["requests"] == 4 and report["tokens"] == 32
    assert [tuple(ids.shape) for ids in report["ids"]] == [(2, 8), (2, 8)]


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-moe-235b-a22b",
                                  "starcoder2-15b"])
def test_serve_equals_reference_serve(arch, capsys, monkeypatch):
    """The reference's CLI run, its params recorded, then the port's
    ``serve`` on those params with the same arguments: the same sample
    ids a batch and the same counts."""
    seen = {}
    build = RS.build_model

    def spy_build(cfg):
        model = build(cfg)
        init = model.init

        def recording_init(key):
            seen["params"] = init(key)
            return seen["params"]

        model.init = recording_init
        return model

    monkeypatch.setattr(RS, "build_model", spy_build)
    RS.main(["--arch", arch, *ARGS, "--seed", "3"])
    want = SAMPLE.findall(capsys.readouterr().out)
    model = build_model(get_smoke_config(arch))
    params = params_from_arrays(jax.tree.map(np.asarray, seen["params"]),
                                "cpu")
    report = TS.serve(model, params, requests=4, batch=2, prompt_len=16,
                      gen_len=8, seed=3, device=torch.device("cpu"))
    got = SAMPLE.findall(capsys.readouterr().out)
    assert len(want) == 2 and got == want
    assert report["tokens"] == 32


def test_generate_reads_no_host_value_and_returns_the_picked_logits():
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = TS.prompt_batch(cfg, np.random.default_rng(0), 2, 8, "cpu")
    ids, logits = TS.generate(model, params, batch, 4, cache_len=12)
    assert ids.shape == (2, 4) and ids.dtype == torch.int32
    assert logits.shape == (2, 4, 512)
    assert torch.equal(ids, torch.argmax(logits, -1).to(torch.int32))
