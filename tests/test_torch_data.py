"""The port's data pipeline and paper-dataset configs against the
reference's: ``make_batch_for`` and ``SyntheticLMDataset`` bit-equal for
every family and kind (both draw from numpy's ``default_rng``), and the
``gunrock_graphs`` datasets equal on the port's generators."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gunrock_graphs as RGG
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import SyntheticLMDataset as RefDataset
from repro.data import make_batch_for as ref_make_batch_for
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs import gunrock_graphs as TGG
from repro_torch.core import graph as TG
from repro_torch.data import SyntheticLMDataset, make_batch_for


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bfloat16:
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seq_len", [32, 130])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_for_equals_reference(arch, kind, seq_len):
    shape = {"global_batch": 3, "seq_len": seq_len}
    want = ref_make_batch_for(ref_get_smoke_config(arch), shape, kind,
                              seed=5)
    got = make_batch_for(get_smoke_config(arch), shape, kind, seed=5,
                         device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])


def test_make_batch_for_bf16_equals_reference():
    """A full config's compute dtype (bf16): the embeddings equal bit for
    bit."""
    shape = {"global_batch": 2, "seq_len": 8}
    want = ref_make_batch_for(ref_get_smoke_config("qwen2-vl-2b").replace(
        compute_dtype=jnp.bfloat16), shape, "prefill", seed=1)
    got = make_batch_for(get_smoke_config("qwen2-vl-2b").replace(
        compute_dtype=torch.bfloat16), shape, "prefill", seed=1,
        device="cpu")
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("seq_len", [1, 63, 64, 200])
def test_dataset_stream_and_resume_equal_reference(seq_len):
    ref = RefDataset(vocab=500, seq_len=seq_len, global_batch=4, seed=3)
    ds = SyntheticLMDataset(vocab=500, seq_len=seq_len, global_batch=4,
                            seed=3, device="cpu")
    for _ in range(3):
        want, got = ref.next_batch(), ds.next_batch()
        for k in ("tokens", "labels"):
            _same(got[k], want[k])
    state = ds.state()
    assert state == ref.state()
    after = ds.next_batch()
    resumed = SyntheticLMDataset(vocab=500, seq_len=seq_len, global_batch=4,
                                 device="cpu")
    resumed.restore(state)
    again = resumed.next_batch()
    assert torch.equal(after["tokens"], again["tokens"])
    assert torch.equal(after["labels"], again["labels"])


def test_paper_dataset_table_equals_reference():
    assert sorted(TGG.PAPER_DATASETS) == sorted(RGG.PAPER_DATASETS)
    for name, entry in RGG.PAPER_DATASETS.items():
        mine = TGG.PAPER_DATASETS[name]
        for k in ("family", "paper_nm", "scaled_by"):
            assert mine[k] == entry[k], (name, k)


@pytest.mark.parametrize("name", ["hollywood-09", "soc-livejournal1",
                                  "rgg_n_24", "roadnet_USA"])
def test_paper_datasets_equal_reference(name):
    jg = RGG.make_paper_dataset(name)
    tg = TGG.make_paper_dataset(name, device="cpu")
    assert (tg.num_vertices, tg.num_edges) == (jg.num_vertices,
                                               jg.num_edges)
    for f in TG.TENSOR_FIELDS:
        want, got = getattr(jg, f), getattr(tg, f)
        if want is None or np.asarray(want).shape == ():
            assert got is None, (name, f)
            continue
        assert np.array_equal(got.numpy(), np.asarray(want)), (name, f)
    assert tg.ell_width == jg.ell_width
