"""Plain PyTorch models of the arithmetic of the redesigned K4 and K7,
held against the JAX package on the CPU. Inputs are made with numpy from
a seed and handed to both.

  * K7's split form (``kernels.ref.attention_partials``: each q tile's kv
    tiles cut into parts, P split into a high and a low piece of the
    input type, or 3xTF32 for fp32) and its combine
    (``kernels.ref.attention_combine``) against the reference kernel
    ``repro.kernels.ops.flash_attention`` in interpret mode, within the
    reference's own limits (3e-5 fp32, 2e-2 bf16; tests/test_kernels.py
    and tests/test_torch_kernels.py); rows with no visible key are
    exactly 0, and parts that see no key carry m = -1e30, l = 0.
  * K4's fold as the card runs it (a light row of d edges: the halving
    tree over pow2(d) leaves, then one (+) with the semiring's zero when
    pow2(d) < pow2(width); a heavy row: the tree over pow2(width) leaves
    of its first width edges, then its overflow one edge at a time in
    edge order) bit for bit against ``repro.linalg.ops.hybrid_ell_reduce``
    for the five semirings, structural and signed weights, on the
    reference's rmat(9, 8, seed=7) and grid2d(20) and at other widths.
  * K4m's fold as the card runs it (every column of a row of at most
    ``SPMM_SPLIT`` edges in ascending edge order from the fold's
    identity; a longer row cut into ``spmm_shares(k)`` contiguous shares,
    each folded so, then merged in share order) against the public
    ``repro.linalg.ops.spmm`` (xla provider): bit for bit on the unsplit
    rows, and within rtol 1e-5 (atol 1e-5) on the split ones, the limit
    the reference keeps between its providers; the five fp32 semirings
    and bf16 plus_times, structural and signed weights, k in {1, 3, 4, 5,
    32, 33, 64}, on rmat(9, 8, seed=7), the directed rmat(8, 8, seed=3)
    and a graph with one row above the split threshold.
  * K8's walk (the slots ordered by token by a counting sort, each row
    gathered in that order and scattered to its slots) bit for bit against the reference
    kernel ``repro.kernels.ops.moe_gather`` in interpret mode on shuffled,
    repeated, -1 and out-of-range slot ids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.kernels import ops as JK
from repro.linalg import ops as JL
from repro.linalg import semiring as JS
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as P
from repro_torch.linalg import semiring as TS

SEMIRINGS = sorted(TS.SEMIRINGS)


# ---- K7: split kv, P in pieces, combine --------------------------------

@pytest.mark.parametrize("sq,sk,d,causal,dtype,nsplit", [
    (64, 64, 32, True, "float32", 1),
    (100, 37, 16, True, "float32", 3),
    (16, 256, 64, False, "float32", 4),
    (96, 160, 112, True, "float32", 2),
    (1, 300, 24, True, "float32", 5),
    (64, 64, 32, True, "bfloat16", 2),
    (96, 160, 112, True, "bfloat16", 3),
    (130, 200, 40, True, "bfloat16", 7),
    (200, 130, 8, True, "bfloat16", 4),
])
def test_split_kv_model_matches_reference_kernel(sq, sk, d, causal, dtype,
                                                 nsplit):
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    acc, ml = P.attention_partials(tq, tk, tv, causal, nsplit)
    assert acc.shape == (nsplit, sq, d) and ml.shape == (nsplit, sq, 2)
    got = P.attention_combine(acc, ml, tq.dtype)
    want = np.asarray(JK.flash_attention(jq, jk, jv, causal=causal, bq=32,
                                         bk=32), np.float32)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    if causal and sq > sk:                      # rows that see no key
        assert (got[:sq - sk] == 0).all() and (want[:sq - sk] == 0).all()


def test_split_kv_model_parts_that_see_no_key():
    """Causal Sq > Sk cut into 6 parts: whole parts see no key (m =
    -1e30, l = 0, acc = 0), the rows that see no key come out exactly 0,
    and the rest match the reference kernel."""
    rng = np.random.default_rng(12)
    sq, sk, d = 300, 150, 16
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    acc, ml = P.attention_partials(*(torch.from_numpy(a) for a in (q, k, v)),
                                   True, 6)
    empty = ml[..., 1] == 0
    assert bool(empty.any()) and bool((~empty).any())
    assert (ml[..., 0][empty] == P.ATTN_NEG).all()
    assert (acc[empty] == 0).all()
    got = P.attention_combine(acc, ml, torch.float32).numpy()
    want = np.asarray(JK.flash_attention(*(jnp.asarray(a) for a in (q, k, v))))
    assert (got[:sq - sk] == 0).all()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("sq,sk,dtype,want", [
    (8192, 8192, torch.bfloat16, 3),     # 128 q tiles: 3 parts fill 132 SMs
    (128, 8192, torch.bfloat16, 64),     # 2 q tiles, 128 kv tiles of 64
    (128, 8192, torch.float32, 128),     # fp32 kv tiles are 32 keys
    (20000, 4096, torch.float16, 1),     # 313 q tiles fill the card
    (1, 100, torch.bfloat16, 1),         # 2 kv tiles: no part of 2 tiles
])
def test_attention_splits(sq, sk, dtype, want):
    """K7 splits the kv axis only when its q tiles cannot fill the card
    about twice over, and keeps at least two kv tiles a part."""
    assert K.attention_splits(sq, sk, dtype, 132) == want


def test_tf32_round_keeps_ten_fraction_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11,
                      1.0 + 2 ** -10, 3.14159265], dtype=torch.float32)
    got = P.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10,
                         -1.0 - 2 ** -10, 1.0 + 2 ** -10, 3.140625])
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()


# ---- K4: the narrow tree and the ordered chain ---------------------------

def _pow2(d: np.ndarray) -> np.ndarray:
    p = np.ones_like(d)
    while (p < d).any():
        p = np.where(p < d, p * 2, p)
    return p


def narrow_fold(offsets: np.ndarray, indices: np.ndarray, values, x,
                sr, width: int) -> torch.Tensor:
    """K4's fold, class by class as the kernel groups its rows; the raw
    (rows,) vector of ``hybrid_ell_reduce`` (an empty row holds zero)."""
    off = torch.from_numpy(offsets.astype(np.int64))
    idx = torch.from_numpy(indices.astype(np.int64))
    vals = None if values is None else torch.from_numpy(values)
    xt = torch.from_numpy(x)
    deg = np.diff(offsets)
    wp = int(_pow2(np.array([width]))[0])
    n = len(deg)
    y = torch.full((n,), sr.zero, dtype=torch.float32)

    def products(e, ok, clamp):
        cols = idx[e]
        if clamp:
            cols = cols.clamp(0, len(x) - 1)
        xv = xt[cols]
        p = xv if vals is None else sr.mul_op(vals[e], xv)
        return torch.where(ok, p, torch.tensor(sr.zero, dtype=torch.float32))

    def tree(rows, leaves, lim):
        lanes = torch.arange(leaves)
        ok = lanes[None, :] < torch.from_numpy(lim)[:, None]
        e = (off[rows][:, None] + lanes[None, :]).clamp(max=max(len(idx) - 1,
                                                                0))
        p = products(e, ok, clamp=True)
        k = leaves
        while k > 1:
            k //= 2
            p = sr.add_op(p[:, :k], p[:, k:2 * k])
        return p[:, 0]

    light = (deg >= 1) & (deg <= width)
    g = _pow2(np.maximum(deg, 1))
    for leaves in sorted(set(g[light].tolist())):
        rows = np.nonzero(light & (g == leaves))[0]
        v = tree(torch.from_numpy(rows), leaves, deg[rows])
        if leaves < wp:
            v = sr.add_op(v, torch.tensor(sr.zero, dtype=torch.float32))
        y[rows] = v
    heavy = np.nonzero(deg > width)[0]
    if len(heavy):
        rows = torch.from_numpy(heavy)
        v = tree(rows, wp, np.full(len(heavy), width))
        over = deg[heavy] - width
        for r in range(int(over.max())):        # the chain, rank by rank
            live = np.nonzero(over > r)[0]
            e = off[rows[live]] + width + r
            v[live] = sr.add_op(v[live], products(e, torch.ones(len(live),
                                                                dtype=bool),
                                                  clamp=False))
        y[heavy] = v
    return y


def _overflow(offsets: np.ndarray, width: int):
    seg = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                    np.diff(offsets))
    rank = np.arange(len(seg)) - offsets[:-1][seg]
    pos = np.nonzero(rank >= width)[0].astype(np.int32)
    return pos, seg[pos]


@pytest.fixture(scope="module", params=["rmat", "grid"])
def csr(request):
    g = (JG.rmat(9, 8, seed=7, weighted=True) if request.param == "rmat"
         else JG.grid2d(20, weighted=True, seed=3))
    return (np.asarray(g.row_offsets), np.asarray(g.col_indices),
            g.ell_width)


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("weights", ["structural", "signed"])
def test_narrow_fold_matches_hybrid_ell_reduce_bitwise(csr, sr, weights):
    offsets, indices, graph_width = csr
    rng = np.random.default_rng(5)
    m, n = len(indices), len(offsets) - 1
    values = (None if weights == "structural"
              else rng.standard_normal(m).astype(np.float32))
    x = rng.standard_normal(n).astype(np.float32)
    deg = np.diff(offsets)
    for width in sorted({graph_width, 1, 3, 16, 33}):
        pos, row = _overflow(offsets, width)
        want = JL.hybrid_ell_reduce(
            jnp.asarray(offsets), jnp.asarray(indices),
            None if values is None else jnp.asarray(values), jnp.asarray(x),
            JS.SEMIRINGS[sr], width, over_pos=jnp.asarray(pos),
            over_row=jnp.asarray(row))
        got = narrow_fold(offsets, indices, values, x, TS.SEMIRINGS[sr],
                          width)
        want = np.asarray(want)
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), width
    # rows of exactly width and width + 1 edges are among them
    assert (deg == 3).any() and (deg == 4).any()


# ---- K4m: each column in edge order, split rows in shares -----------------

def spmm_fold(offsets: np.ndarray, indices: np.ndarray, values, x, sr,
              mask=None) -> torch.Tensor:
    """K4m's (n, k) result as the kernel folds it (csrc/spmv.cu)."""
    off = torch.from_numpy(offsets.astype(np.int64))
    deg = off[1:] - off[:-1]
    n, k = len(deg), x.shape[1]
    xv = torch.from_numpy(x)[torch.from_numpy(indices.astype(np.int64))]
    prod = (sr.round_prod(xv) if values is None
            else sr.mul_op(torch.from_numpy(values)[:, None], xv))
    prod = prod.to(torch.float32)
    init = float("-inf") if sr.name == "or_and" else sr.zero
    unsplit = torch.nonzero(deg <= K.SPMM_SPLIT).squeeze(1)
    split = torch.nonzero(deg > K.SPMM_SPLIT).squeeze(1)
    shares = K.spmm_shares(k)
    # fold segments: every unsplit row whole, then each split row's shares
    starts, lens = [off[unsplit]], [deg[unsplit]]
    for r in split.tolist():
        s, e = int(off[r]), int(off[r + 1])
        ln = -(-(e - s) // shares)
        s0 = torch.clamp(s + torch.arange(shares) * ln, max=e)
        starts.append(s0)
        lens.append(torch.clamp(s0 + ln, max=e) - s0)
    starts, lens = torch.cat(starts), torch.cat(lens)
    v = torch.full((len(starts), k), init, dtype=torch.float32)
    for r in range(int(lens.max()) if len(lens) else 0):
        live = lens > r
        v[live] = sr.add_op(v[live], prod[starts[live] + r])
    y = torch.full((n, k), sr.zero, dtype=torch.float32)
    y[unsplit] = v[:len(unsplit)]
    parts = v[len(unsplit):].reshape(len(split), shares, k)
    if len(split):
        t = parts[:, 0]
        for q in range(1, shares):                # the shares in order
            t = sr.add_op(t, parts[:, q])
        y[split] = t
    y[deg == 0] = sr.zero
    if mask is not None:
        y[~torch.from_numpy(mask)] = sr.zero
    return y


def _one_long_row_csr():
    """600 vertices: row 0 holds 400 edges (above SPMM_SPLIT), the rest
    0-12 each; columns sorted and distinct within a row."""
    rng = np.random.default_rng(11)
    n = 600
    deg = rng.integers(0, 13, n)
    deg[0] = 400
    assert (deg > K.SPMM_SPLIT).sum() == 1
    cols = [np.sort(rng.choice(np.arange(1, n), d, replace=False))
            for d in deg]
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return offsets, np.concatenate(cols).astype(np.int32)


@pytest.fixture(scope="module", params=["rmat", "directed", "long_row"])
def spmm_csr(request):
    if request.param == "long_row":
        return _one_long_row_csr()
    g = (JG.rmat(9, 8, seed=7, weighted=True) if request.param == "rmat"
         else JG.rmat(8, 8, seed=3, weighted=True, undirected=False))
    return np.asarray(g.row_offsets), np.asarray(g.col_indices)


@pytest.mark.parametrize("sr,precision", [(s, "fp32") for s in SEMIRINGS]
                         + [("plus_times", "bf16")])
@pytest.mark.parametrize("weights", ["structural", "signed"])
def test_spmm_fold_matches_reference(spmm_csr, sr, precision, weights):
    offsets, indices = spmm_csr
    n, m = len(offsets) - 1, len(indices)
    rng = np.random.default_rng(23)
    values = rng.standard_normal(m).astype(np.float32)
    jg = JG.Graph.from_csr(offsets, indices, values)
    tsr = TS.with_precision(sr, precision)
    deg = np.diff(offsets)
    unsplit = deg <= K.SPMM_SPLIT
    mask = rng.random(n) < 0.7
    for k in (1, 3, 4, 5, 32, 33, 64):
        x = rng.random((n, k)).astype(np.float32)
        m_k = mask if k == 5 else None
        want = np.asarray(JL.spmm(jg, x, semiring=JS.get(sr),
                                  structural=weights == "structural",
                                  mask=m_k, backend="xla",
                                  precision=precision))
        got = spmm_fold(offsets, indices,
                        None if weights == "structural" else values, x, tsr,
                        m_k).numpy()
        assert np.array_equal(got[unsplit].view(np.int32),
                              want[unsplit].view(np.int32)), k
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the long-row graph has one split row, the rmat graphs none
    assert int((~unsplit).sum()) == (1 if n == 600 else 0)


def test_spmm_shares():
    """A group is pow2(ceil(min(k, 32) / 4)) lanes, at most 8; a block
    of SPMM_THREADS threads has SPMM_THREADS / lanes groups."""
    want = {1: 256, 3: 256, 4: 256, 5: 128, 8: 128, 9: 64, 16: 64, 17: 32,
            32: 32, 33: 32, 64: 32}
    assert {k: K.spmm_shares(k) for k in want} == want


# ---- K8: gather in token order, scatter to the slots ----------------------

def moe_walk(x: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """K8's walk: the slots ordered by bin (0 for an empty slot, 1 + the
    clamped token otherwise), as its counting sort orders them; position
    j copies its bin's row (zeros for bin 0) to slot order_j."""
    t = x.shape[0]
    bins = torch.where(slot_token < 0, 0, slot_token.clamp(max=t - 1) + 1)
    bins, order = torch.sort(bins)
    rows = x[(bins - 1).clamp(min=0).long()]
    rows[bins == 0] = 0
    out = torch.empty((len(slot_token), x.shape[1]), dtype=x.dtype)
    out[order] = rows
    return out


@pytest.mark.parametrize("case", ["shuffled", "repeated", "empty",
                                  "past_end", "mixed"])
def test_moe_walk_matches_reference_kernel(case):
    rng = np.random.default_rng(len(case))
    t, d = 37, 24
    x = rng.standard_normal((t, d)).astype(np.float32)
    slot = {"shuffled": rng.permutation(t),
            "repeated": rng.integers(0, 4, 90),
            "empty": np.full(40, -1),
            "past_end": rng.integers(t - 2, t + 9, 50),
            "mixed": np.concatenate([rng.permutation(t), np.full(7, -1),
                                     [t, t + 100, 0, 0, 5]])}[case]
    slot = rng.permutation(slot).astype(np.int32)
    got = moe_walk(torch.from_numpy(x), torch.from_numpy(slot))
    want = np.asarray(JK.moe_gather(jnp.asarray(x), jnp.asarray(slot)))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
