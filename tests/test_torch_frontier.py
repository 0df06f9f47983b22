"""Port frontiers against the reference: compaction with the (buf,
lengths, totals) clamp semantics, the dense↔sparse conversions and the
capacity-tier ladder. Inputs are numpy arrays made from a seed; ints
must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro_torch.core import backend as TB
from repro_torch.core import frontier as TF
from repro_torch.kernels import ops as K


def _inputs(b, cap, p, seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1000, size=(b, cap)).astype(np.int32)
    mask = rng.random((b, cap)) < p
    return values, mask


@pytest.mark.parametrize("capacity", [5, 64, 100])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_values_batch_matches_reference(capacity, p):
    values, mask = _inputs(3, 64, p, seed=capacity)
    jb, jl, jt = JF.compact_values_batch(jnp.asarray(values),
                                         jnp.asarray(mask), capacity,
                                         fill=-7, backend="xla")
    tb, tl, tt = TF.compact_values_batch(torch.from_numpy(values),
                                         torch.from_numpy(mask), capacity,
                                         fill=-7)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_compact_values_single_clamps():
    values, mask = _inputs(1, 50, 0.6, seed=1)
    jb, jl = JF.compact_values(jnp.asarray(values[0]), jnp.asarray(mask[0]),
                               10, backend="xla")
    tb, tl = TF.compact_values(torch.from_numpy(values[0]),
                               torch.from_numpy(mask[0]), 10)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert int(jl) == int(tl) == 10


def test_compact_kernel_wrapper_on_cpu_is_the_plain_version():
    values, mask = _inputs(4, 300, 0.4, seed=2)
    before = K.KERNELS["compact"].launches
    kp, kt = K.compact(torch.from_numpy(values), torch.from_numpy(mask))
    pp, pt = TF._compact_torch(torch.from_numpy(values),
                               torch.from_numpy(mask))
    assert torch.equal(kp, pp) and torch.equal(kt, pt)
    # the CPU path launches nothing
    assert K.KERNELS["compact"].launches == before


def test_compact_matches_pallas_kernel():
    """K2's reference kernel, run as the reference's tests run it on the
    CPU (Pallas interpret mode); ints equal."""
    values, mask = _inputs(2, 300, 0.5, seed=3)
    jb, jl, jt = JF.compact_values_batch(jnp.asarray(values),
                                         jnp.asarray(mask), 300,
                                         backend="pallas")
    tb, tl, tt = TF.compact_values_batch(torch.from_numpy(values),
                                         torch.from_numpy(mask), 300)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_dense_sparse_conversions_match_reference():
    rng = np.random.default_rng(4)
    flags = rng.random((3, 40)) < 0.3
    js = JF.BatchedDenseFrontier(jnp.asarray(flags)).to_sparse(
        25, backend="xla")
    ts = TF.BatchedDenseFrontier(torch.from_numpy(flags)).to_sparse(25)
    assert np.array_equal(np.asarray(js.ids), ts.ids.numpy())
    assert np.array_equal(np.asarray(js.lengths), ts.lengths.numpy())
    jd = js.to_dense(40)
    td = ts.to_dense(40)
    assert np.array_equal(np.asarray(jd.flags), td.flags.numpy())
    assert np.array_equal(np.asarray(jd.lengths), td.lengths.numpy())
    one = TF.DenseFrontier(torch.from_numpy(flags[0])).to_sparse()
    ref = JF.DenseFrontier(jnp.asarray(flags[0])).to_sparse(backend="xla")
    assert np.array_equal(np.asarray(ref.ids), one.ids.numpy())
    assert int(ref.length) == int(one.length)
    assert np.array_equal(np.asarray(ref.to_dense(40).flags),
                          one.to_dense(40).flags.numpy())


def test_from_ids_batch_matches_reference():
    j = JF.from_ids_batch([3, 1, 4], 6)
    t = TF.from_ids_batch([3, 1, 4], 6)
    assert np.array_equal(np.asarray(j.ids), t.ids.numpy())
    assert np.array_equal(np.asarray(j.lengths), t.lengths.numpy())
    f = TF.from_ids([5, 9], 4)
    assert f.ids.tolist() == [5, 9, -1, -1] and int(f.length) == 2


@pytest.mark.parametrize("cap", [1, 100, 512, 513, 5000, 97194])
def test_tier_ladder_matches_reference(cap):
    caps = TF.tier_caps(cap)
    assert caps == JF.tier_caps(cap)
    assert TB.tier_plan("advance", cap) == caps
    for need in (0, 1, 511, 512, 513, 2049, cap, cap + 10 ** 6):
        assert TF.tier_index(need, caps) == int(
            JF.tier_index(jnp.int32(min(need, 2 ** 31 - 1)), caps))


@pytest.mark.parametrize("capacity", [1, 7, 512])
def test_empty_frontier_matches_reference(capacity):
    want = JF.empty(capacity)
    got = TF.empty(capacity, device="cpu")
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert int(got.length) == int(want.length) == 0
    assert got.ids.dtype == torch.int32 and got.capacity == capacity
    assert not got.valid_mask.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TF.empty(capacity)
