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
    exactly 0, and parts that see no key carry m = -1e30, l = 0. K7c's
    summation order (a row's parts dealt to its 1, 2, 4 or 8 warps, the
    denominator over the row's threads and a butterfly, the warps merged
    in order) against the plain combine and the reference kernel, within
    the same limits.
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
  * K1's and K2's single-pass arithmetic: the decoupled look-back (tiles
    stepping in a random interleaving over statuses an earlier call
    left), K1's offsets scan with each slot tile's first lane, its tile
    partition (lane starts marked, a running maximum), its expand and
    emit passes over live slots with the candidate mask and the tail
    fill, and K2's 16-byte mask groups and staged emit, bit for bit
    against ``kernels/ref.py`` (and K1 against the reference's xla
    provider, K2 against ``repro.kernels.ref.filter_compact_ref``) on
    zero-size lanes, cap_in = 0, totals past cap_out, survivors past
    cap_front, tiles spanning thousands of lanes, and masks whose length
    is no multiple of 16.
  * K3's and K6's tile arithmetic: the same offsets scan and partition,
    then each live slot's outputs with no search (in_pos its lane, rank
    from its lane's start in the tile, K3's CSR gathers) and the dead
    tail's constants (K6: rank slot - offsets[cap_in - 1]) filled by the
    lane's blocks, at 64, 256 and 1024 threads, bit for bit against
    ``kernels/ref.py`` and the reference's ``advance_fused_batch_kernel``
    and ``lb_expand_kernel`` in interpret mode: int16 / int32 / int64 and
    delta columns, cap_in = 0, zero-size lanes, totals past cap_out, a
    lane spanning many tiles, tiles spanning many lanes.
  * K5's rows: chunks of 32 lanes a row, a thread's rows searched in
    rounds, the clamp skipped in a warp whose segments all lie inside the
    haystack, the answer from the value read at the last move of hi, bit
    for bit against ``kernels/ref.py`` (int16 / int32 / int64 haystacks)
    and the reference's ``segment_search_kernel`` in interpret mode, in
    both modes, on the cases of ``tests/_k5_cases.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.kernels import ops as JK
from repro.kernels import ref as JF
from repro.linalg import ops as JL
from repro.linalg import semiring as JS
from repro_torch.core import graph as TG
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as P
from repro_torch.linalg import semiring as TS

from _k5_cases import K5_CASES, K5_PATHS, k5_case

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


def _comb_group(nsplit):
    """K7c's warps a row (csrc/attention.cu, comb_group): the fewest of 1,
    2, 4, 8 whose first 8 loads a lane cover every part."""
    return 1 if nsplit <= 8 else 2 if nsplit <= 16 else 4 if nsplit <= 32 \
        else 8


def _combine_model(acc, ml, dtype):
    """K7c's arithmetic in the card's order, G = ``_comb_group(nsplit)``
    warps a row: M = max m; w_s = exp(m_s - M); the denominator summed by
    the row's thread s mod 32 G in increasing s, then a butterfly over
    each warp's 32 lanes, then the row's warps in order; the sums of w_s
    acc_s with part s dealt to warp s mod G, each warp in increasing s,
    the warps merged in order; one division, one rounding to ``dtype``.
    Every product is rounded before its sum (the kernels are built with
    -fmad=false)."""
    nsplit, sq, d = acc.shape
    g = _comb_group(nsplit)
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp(m - m.max(dim=0).values)
    lanes = torch.zeros((32 * g, sq))
    for s in range(nsplit):
        lanes[s % (32 * g)] += w[s] * l[s]
    lanes = lanes.view(g, 32, sq)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ off]
    den = lanes[0, 0]
    parts = torch.zeros((g, sq, d))
    for s in range(nsplit):
        parts[s % g] += w[s][:, None] * acc[s]
    y = parts[0]
    for warp in range(1, g):
        den = den + lanes[warp, 0]
        y = y + parts[warp]
    return (y / torch.clamp(den, min=1e-30)[:, None]).to(dtype)


@pytest.mark.parametrize("sq,sk,d,causal,dtype,nsplit", [
    (64, 64, 32, True, "float32", 2),
    (100, 37, 16, True, "float32", 7),
    (16, 1024, 112, False, "float32", 128),   # 32 kv tiles: 96 parts empty
    (8, 640, 8, False, "float32", 300),       # parts past one per thread
    (128, 2048, 128, True, "bfloat16", 64),   # the chunk's 64 parts
    (200, 130, 40, True, "bfloat16", 9),      # rows that see no key
    (50, 700, 24, True, "float32", 20),       # 4 warps a row
])
def test_combine_model_matches_reference_kernel(sq, sk, d, causal, dtype,
                                                nsplit):
    """K7c's summation order, on the split form's parts, against the
    plain combine (``kernels.ref.attention_combine``) and the reference
    kernel in interpret mode, within the limits above; rows that see no
    key exactly 0."""
    rng = np.random.default_rng(sq + sk * 3 + nsplit)
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    acc, ml = P.attention_partials(tq, tk, tv, causal, nsplit)
    got = _combine_model(acc, ml, tq.dtype)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    torch.testing.assert_close(
        got.float(), P.attention_combine(acc, ml, tq.dtype).float(),
        rtol=tol, atol=tol)
    want = np.asarray(JK.flash_attention(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
        causal=causal, bq=32, bk=32), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    if causal and sq > sk:
        assert (got[:sq - sk] == 0).all() and (want[:sq - sk] == 0).all()


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


# ---- K1 and K2: block-level LB partition, look-back compaction ----------

INT32_MAX = 2 ** 31 - 1


def look_back(counts, rng, epoch=7):
    """Exclusive prefixes of tiles with ``counts`` by decoupled look-back
    (csrc/common.cuh ``tile_prefix``): every tile runs from the start and
    one random tile takes one step at a time — publish its aggregate
    (tile 0: its prefix), read one predecessor's status (a word of
    another epoch, or none, reads as not written: the step is spent
    spinning), publish its inclusive prefix. The status words start as
    the words an earlier call left (epoch - 1, prefix flag)."""
    n = len(counts)
    status = [(epoch - 1, 2, 10_000)] * n
    prefix = [None] * n
    state = {j: None for j in range(n)}            # None: not published
    while state:
        j = int(rng.choice(list(state)))
        if state[j] is None:
            if j == 0:
                status[0] = (epoch, 2, int(counts[0]))
                prefix[0] = 0
                del state[0]
            else:
                status[j] = (epoch, 1, int(counts[j]))
                state[j] = (j - 1, 0)
            continue
        p, acc = state[j]
        e, flag, value = status[p]
        if e != epoch or flag == 0:
            continue
        acc += value
        if flag == 2:
            prefix[j] = acc
            status[j] = (epoch, 2, acc + int(counts[j]))
            del state[j]
        else:
            state[j] = (p - 1, acc)
    return np.asarray(prefix, np.int64)


def offsets_scan(sizes_row, slot_tile, slot_tiles, rng):
    """K1's offsets scan of one lane: tiles of ``K.SCAN_TILE`` sizes, each
    scanned alone and shifted by its look-back prefix; the lane's live
    end (one past its last non-empty input lane); and each slot tile's
    first input lane, found by the scan tile that holds the slot tile's
    first slot (the first of its inclusive sums above the slot), -1
    where no slot tile starts below the total."""
    cap_in = len(sizes_row)
    ntiles = max(-(-cap_in // K.SCAN_TILE), 1)
    tiles = [sizes_row[t * K.SCAN_TILE:(t + 1) * K.SCAN_TILE]
             for t in range(ntiles)]
    pre = look_back([int(t.sum()) for t in tiles], rng)
    offs = np.concatenate([[0]] + [p + np.cumsum(t) for p, t in
                                   zip(pre, tiles)]).astype(np.int64)
    tile_lane = np.full(slot_tiles + 1, -1, np.int64)
    for t, (p, part) in enumerate(zip(pre, tiles)):
        if part.sum() == 0:
            continue
        inc = p + np.cumsum(np.pad(part, (0, K.SCAN_TILE - len(part))))
        lo = -(-int(p) // slot_tile)
        hi = min((int(p) + int(part.sum()) - 1) // slot_tile, slot_tiles)
        for k in range(lo, hi + 1):
            tile_lane[k] = t * K.SCAN_TILE + np.searchsorted(
                inc, k * slot_tile, side="right")
    nz = np.flatnonzero(sizes_row)
    return offs, int(nz[-1]) + 1 if len(nz) else 0, tile_lane


def tile_lanes(sizes_row, offs, le, tile_lane, j, tile, s0, s_end):
    """The partition of tile j (K1, K3, K6), the slots [s0, s_end): the
    lane of s0 from the scan, each non-empty lane after it (its size is
    not 0) that starts below s_end (up to the next tile's first lane, or
    the live end) marked at its start; for each slot, by a running
    maximum, the tile position q where its lane starts, and that lane."""
    p0 = tile_lane[j]
    p1 = tile_lane[j + 1] if (j + 1) * tile < offs[-1] else le - 1
    assert p0 >= 0 and p1 >= p0
    mark = np.full(s_end - s0, -1)
    lane_at = np.zeros(s_end - s0, np.int64)
    mark[0], lane_at[0] = 0, p0
    for lane in range(p0 + 1, p1 + 1):
        if sizes_row[lane] != 0 and offs[lane] < s_end:
            p = offs[lane] - s0
            assert 0 < p < s_end - s0
            mark[p], lane_at[p] = p, lane
    q = np.maximum.accumulate(mark)
    return q, lane_at[q]


def fill_tail(row, lo, hi, blocks, value=-1):
    """``fill_tail`` and the fills of K3's and K6's dead tails: row[i] =
    value (or value(i) for an array of indices) on [lo, hi), in
    ``blocks`` contiguous parts."""
    part = -(-(hi - lo) // blocks) if hi > lo else 0
    for x in range(blocks):
        a = min(lo + part * x, hi)
        z = min(a + part, hi)
        row[a:z] = value(np.arange(a, z)) if callable(value) else value


def advance_filter_model(ro, col_at, base, sizes, visited, cap_out,
                         cap_front, threads, rng):
    """K1 as the card runs it: the offsets scan, then the expand pass and
    the emit pass over the live slots in tiles of ``K.lb_tile(threads)``,
    the tiles of each pass in a random order; a slot that reads a larger
    first is a candidate, and only candidates are tested in the emit
    pass; the emit's prefixes by look-back, the tail by the lane's
    blocks. Returns (ids, srcs, lengths, totals, first)."""
    b, cap_in = sizes.shape
    n = visited.shape[1]
    tile = K.lb_tile(threads)
    ids = np.full((b, cap_front), 777, np.int32)     # torch.empty
    srcs = np.full((b, cap_front), 777, np.int32)
    lengths = np.zeros(b, np.int32)
    totals = np.zeros(b, np.int32)
    first = np.full((b, n), INT32_MAX, np.int64)
    slot_tiles = max(-(-cap_out // tile), 1)
    for lane in range(b):
        offs, le, tile_lane = offsets_scan(sizes[lane], tile, slot_tiles,
                                           rng)
        live = min(int(offs[cap_in]), cap_out)
        ntiles = -(-live // tile)

        def expand(j):
            s0 = j * tile
            s_end = min(s0 + tile, live)
            slots = np.arange(s0, s_end)
            _, lanes = tile_lanes(sizes[lane], offs, le, tile_lane, j,
                                  tile, s0, s_end)
            src = base[lane][lanes]
            eid = ro[src] + slots - offs[lanes]
            return slots, src, np.array([col_at(e, s) for e, s in
                                         zip(eid, src)], np.int64)

        cand = np.zeros(ntiles * tile, bool)
        for j in rng.permutation(ntiles):            # expand pass
            for slot, _, d in zip(*expand(j)):
                if not visited[lane, d] and slot < first[lane, d]:
                    cand[slot] = True                # read a larger first
                    first[lane, d] = slot
        keep = {}
        for j in rng.permutation(ntiles):            # emit pass, reads
            slots, src, d = expand(j)
            won = cand[slots] & (first[lane, d] == slots)
            keep[j] = (src[won], d[won])
            first[lane, d[won]] = INT32_MAX          # the survivors reset
        pre = look_back([len(keep[j][0]) for j in range(ntiles)], rng)
        total = int(pre[-1]) + len(keep[ntiles - 1][0]) if ntiles else 0
        for j in range(ntiles):
            s, d = keep[j]
            pos = pre[j] + np.arange(len(s))
            ok = pos < cap_front
            ids[lane, pos[ok]] = d[ok]
            srcs[lane, pos[ok]] = s[ok]
        totals[lane], lengths[lane] = total, min(total, cap_front)
        blocks = int(rng.integers(1, 9))
        fill_tail(ids[lane], lengths[lane], cap_front, blocks)
        fill_tail(srcs[lane], lengths[lane], cap_front, blocks)
    return ids, srcs, lengths, totals, first


def compact_model(values, mask, threads, rng):
    """K2 as the card runs it: tiles of 16·threads entries, each thread's
    16 mask bytes as a bit mask, the kept positions staged in rank order
    and stored at the tile's look-back prefix; tiles in a random order;
    the tail by the lane's blocks."""
    b, cap = mask.shape
    tile = K.COMPACT_ITEMS * threads
    packed = np.full((b, cap), 777, np.int32)
    totals = np.zeros(b, np.int32)
    ntiles = -(-cap // tile)
    for lane in range(b):
        vrow = values[lane if values.shape[0] == b else 0]
        staged = {}
        for j in rng.permutation(ntiles):
            m = np.zeros(tile, bool)
            part = mask[lane, j * tile:(j + 1) * tile]
            m[:len(part)] = part
            bits = m.reshape(threads, K.COMPACT_ITEMS)
            rank = np.cumsum(bits.sum(axis=1)) - bits.sum(axis=1)
            stage = np.zeros(int(bits.sum()), np.int64)
            for t in range(threads):
                stage[rank[t] + np.arange(bits[t].sum())] = (
                    t * K.COMPACT_ITEMS + np.flatnonzero(bits[t]))
            staged[j] = vrow[j * tile + stage]
        pre = look_back([len(staged[j]) for j in range(ntiles)], rng)
        for j in range(ntiles):
            packed[lane, pre[j]:pre[j] + len(staged[j])] = staged[j]
        total = int(pre[-1]) + len(staged[ntiles - 1]) if ntiles else 0
        totals[lane] = total
        fill_tail(packed[lane], total, cap, int(rng.integers(1, 9)))
    return packed, totals


@pytest.mark.parametrize("seed", range(6))
def test_look_back_prefixes_in_any_order(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, size=int(rng.integers(1, 40)))
    want = np.cumsum(counts) - counts
    assert np.array_equal(look_back(counts, rng, epoch=seed + 1), want)


@pytest.mark.parametrize("tile", [512, 2048])
@pytest.mark.parametrize("seed", range(3))
def test_tile_lanes_are_the_upper_bound(tile, seed):
    """Zero-size lanes between live ones, scan tiles without a slot tile
    and slot tiles spanning scan tiles: each slot tile's first lane is
    the non-empty lane that holds its first slot, as searchsorted(right)
    - 1 finds it."""
    rng = np.random.default_rng(seed)
    cap_in = 3 * K.SCAN_TILE + 123
    sizes = rng.integers(0, 4, cap_in) * (rng.random(cap_in) < 0.4)
    sizes[rng.integers(0, cap_in, 3)] = 3000
    sizes[K.SCAN_TILE:2 * K.SCAN_TILE] = 0
    slot_tiles = -(-int(sizes.sum()) // tile)
    offs, le, tile_lane = offsets_scan(sizes, tile, slot_tiles, rng)
    assert le == np.flatnonzero(sizes)[-1] + 1
    for k in range(slot_tiles):
        want = np.searchsorted(offs[:-1], k * tile, side="right") - 1
        assert tile_lane[k] == want and sizes[want] > 0
    assert tile_lane[slot_tiles] == -1


def _k1_case(case):
    """(graph, base, sizes, visited, cap_out, cap_front) on the CPU."""
    rng = np.random.default_rng(len(case))
    g = (TG.grid2d(24, weighted=True, seed=3, encoding="delta",
                   device="cpu")
         if case == "delta" else TG.rmat(8, 8, seed=3, weighted=True, device="cpu"))
    n, m = g.num_vertices, g.num_edges
    deg = g.degrees.numpy()
    b, cap_in, cap_out, cap_front = 3, 300, m, n
    base = rng.integers(0, n, (b, cap_in))
    live = rng.random((b, cap_in)) < 0.5             # zero-size lanes between
    if case == "cap_in_0":
        cap_in = 0
        base, live = base[:, :0], live[:, :0]
    elif case == "clamped":        # totals past cap_out, survivors past front
        cap_out, cap_front = 700, 40
    elif case == "many_lanes":     # tiles spanning thousands of lanes
        cap_in = 3 * K.SCAN_TILE + 77
        base = rng.integers(0, n, (b, cap_in))
        live = rng.random((b, cap_in)) < 0.05
        live[1, 2000:9000] = False                   # a long empty run
    sizes = np.where(live, deg[base], 0).astype(np.int32)
    if case == "many_lanes":
        sizes = np.minimum(sizes, 1).astype(np.int32)
    visited = rng.random((b, n)) < 0.3
    return g, base.astype(np.int32), sizes, visited, cap_out, cap_front


@pytest.mark.parametrize("threads", [64, 256, 1024])
@pytest.mark.parametrize("case", ["dense", "delta", "cap_in_0", "clamped",
                                  "many_lanes"])
def test_advance_filter_model_matches_plain_version(case, threads):
    """K1's partition, passes, look-back and tail against kernels/ref.py,
    every output bit for bit and ``first`` all INT32_MAX afterwards;
    the int16 rmat and the escape-free delta grid."""
    g, base, sizes, visited, cap_out, cap_front = _k1_case(case)
    store = g.col_store
    ro = g.row_offsets.numpy().astype(np.int64)
    if case == "delta":
        assert store.num_escapes == 0
        anchor, delta = store.anchor.numpy(), store.delta.numpy()

        def col_at(e, s):
            return int(anchor[s]) + int(delta[e])
    else:
        cols = store.numpy()

        def col_at(e, s):
            return int(cols[e])
    rng = np.random.default_rng(threads)
    *got, first = advance_filter_model(ro, col_at, base, sizes, visited,
                                       cap_out, cap_front, threads, rng)
    if case == "cap_in_0":
        # no input lane: both plain versions (and the reference's xla
        # provider) refuse the shape in their gathers; nothing survives
        b = base.shape[0]
        want = (np.full((b, cap_front), -1), np.full((b, cap_front), -1),
                np.zeros(b), np.zeros(b))
    else:
        want = [t.numpy() for t in P.advance_filter_batch(
            g.row_offsets, store, torch.from_numpy(base),
            torch.from_numpy(sizes), torch.from_numpy(visited), cap_out,
            cap_front)]
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    assert (first == INT32_MAX).all()
    if case == "clamped":
        assert (want[3] > cap_front).any() and (
            sizes.sum(axis=1) > cap_out).any()


def test_advance_filter_model_matches_reference():
    """The same model against the JAX package's xla provider."""
    from repro.core import backend as JB
    g, base, sizes, visited, cap_out, cap_front = _k1_case("clamped")
    cols = g.col_store.numpy().astype(np.int32)
    ro = g.row_offsets.numpy()
    *got, _ = advance_filter_model(ro.astype(np.int64),
                                   lambda e, s: int(cols[e]), base, sizes,
                                   visited, cap_out, cap_front, 256,
                                   np.random.default_rng(0))
    want = JB.dispatch("advance_filter_batch", "xla")(
        jnp.asarray(ro), jnp.asarray(cols), jnp.asarray(base),
        jnp.asarray(sizes), jnp.asarray(visited), cap_out, cap_front)
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y))


@pytest.mark.parametrize("threads", [64, 256, 1024])
@pytest.mark.parametrize("cap,p,shared", [
    (5000, 0.4, False), (16_387, 0.5, True), (13, 0.5, False),
    (4096, 1.0, False), (40_000, 0.0, True), (0, 0.5, False)])
def test_compact_model_matches_plain_version(cap, p, shared, threads):
    """K2's tiles, 16-byte mask groups, staging, look-back and tail
    against kernels/ref.py: lengths that are no multiple of 16, all-kept
    and all-dropped masks, a shared values row, cap = 0."""
    rng = np.random.default_rng(cap + threads)
    mask = rng.random((3, cap)) < p
    values = rng.integers(-5, 1000, (1 if shared else 3, cap)).astype(
        np.int32)
    got = compact_model(values, mask, threads, rng)
    want = P.compact(torch.from_numpy(values), torch.from_numpy(mask))
    for x, y in zip(got, want):
        assert np.array_equal(x, y.numpy())
    if cap:
        jpacked, jcount = JF.filter_compact_ref(jnp.asarray(values[0]),
                                                jnp.asarray(mask[0]))
        assert np.array_equal(got[0][0], np.asarray(jpacked))
        assert got[1][0] == int(jcount)


def lb_tiles_model(sizes, cap_out, threads, rng, gather=None):
    """K3 (``gather`` = (row offsets, base, column reader, m)) and K6
    (``gather`` None) as the card runs them: per lane the offsets scan,
    then the live tiles in a random order, each slot's outputs from its
    tile's partition with no search — in_pos its lane, rank i - q (plus
    s0 less the lane's start for the tile's first lane), and the CSR
    gathers (src = base[lane], eid = the lane's edge base + slot, dst =
    the column at the clamped edge) — then valid and the dead tail filled
    by a random number of the lane's blocks in contiguous parts. Returns
    the K3 tuple, or K6's (in_pos, rank, valid, total) for one lane."""
    b, cap_in = sizes.shape
    tile = K.lb_tile(threads)
    slot_tiles = max(-(-cap_out // tile), 1)
    rows = np.full((5, b, cap_out), 777, np.int64)     # torch.empty
    valid = np.full((b, cap_out), 7, np.int64)
    totals = np.zeros(b, np.int64)
    for lane in range(b):
        src, dst, eid, ip, rk = rows[:, lane]
        offs, le, tile_lane = offsets_scan(sizes[lane], tile, slot_tiles,
                                           rng)
        total = totals[lane] = int(offs[cap_in])
        live = max(min(total, cap_out), 0)
        for j in rng.permutation(-(-live // tile)):
            s0 = j * tile
            s_end = min(s0 + tile, live)
            q, lanes = tile_lanes(sizes[lane], offs, le, tile_lane, j, tile,
                                  s0, s_end)
            i = np.arange(s_end - s0)
            ip[s0 + i] = lanes
            rk[s0 + i] = i - q + np.where(q == 0, s0 - offs[lanes[0]], 0)
            if gather is not None:
                ro, base, cols_at, m = gather
                s = base[lane][lanes]
                e = ro[s] - offs[lanes] + s0 + i          # ebase + slot
                src[s0 + i], eid[s0 + i] = s, e
                dst[s0 + i] = cols_at(np.clip(e, 0, m - 1), s)
        blocks = int(rng.integers(1, 9))
        fill_tail(valid[lane], 0, live, 1, 1)
        fill_tail(valid[lane], live, cap_out, blocks, 0)
        fill_tail(ip, live, cap_out, blocks, max(cap_in - 1, 0))
        if gather is None:
            last = total - sizes[lane, -1] if cap_in else 0
            fill_tail(rk, live, cap_out, blocks, lambda s: s - last)
        else:
            for r in (src, dst, eid):
                fill_tail(r, live, cap_out, blocks, -1)
            fill_tail(rk, live, cap_out, blocks, 0)
    if gather is None:
        return rows[3, 0], rows[4, 0], valid[0] == 1, totals[0]
    return (*rows, valid == 1, totals)


def _k3_case(case):
    """(graph, base, sizes, cap_out) on the CPU: the int16 rmat (int32 /
    int64 columns of the same graph), the escape-free delta grid; zero-size
    lanes between live ones in every case."""
    rng = np.random.default_rng(len(case))
    kw = {"index_dtype": case} if case in ("int32", "int64") else {}
    g = (TG.grid2d(24, weighted=True, seed=3, encoding="delta",
                   device="cpu")
         if case == "delta" else TG.rmat(8, 8, seed=3, weighted=True,
                                         device="cpu", **kw))
    n, m = g.num_vertices, g.num_edges
    deg = g.degrees.numpy()
    b, cap_in, cap_out = 3, 300, m
    base = rng.integers(0, n, (b, cap_in))
    live = rng.random((b, cap_in)) < 0.5
    if case == "cap_in_0":
        cap_in = 0
        base, live = base[:, :0], live[:, :0]
    elif case == "clamped":                    # totals past cap_out
        cap_out = 700
    elif case == "many_lanes":                 # tiles spanning many lanes
        cap_in = 3 * K.SCAN_TILE + 77
        base = rng.integers(0, n, (b, cap_in))
        live = rng.random((b, cap_in)) < 0.05
        live[1, 2000:9000] = False
    sizes = np.where(live, deg[base], 0).astype(np.int32)
    if case == "many_lanes":
        sizes = np.minimum(sizes, 1).astype(np.int32)
    elif case == "long_lane":                  # a lane spanning many tiles
        sizes[0, 7] = 5 * K.LB_TILE_SLOTS + 3  # (edge ids run past its row)
        cap_out = int(sizes.sum(axis=1).max()) + 5
    return g, base.astype(np.int32), sizes, cap_out


def _cols_reader(store):
    """Vectorised column reader (edge ids, source rows) → int64 ids."""
    if hasattr(store, "anchor"):
        anchor = store.anchor.numpy().astype(np.int64)
        delta = store.delta.numpy().astype(np.int64)
        return lambda e, s: anchor[s] + delta[e]
    cols = store.numpy().astype(np.int64)
    return lambda e, s: cols[e]


K3_CASES = ["int16", "int32", "int64", "delta", "cap_in_0", "clamped",
            "many_lanes", "long_lane"]


@pytest.mark.parametrize("threads", [64, 256, 1024])
@pytest.mark.parametrize("case", K3_CASES)
def test_advance_model_matches_plain_version(case, threads):
    """K3's scan, partition, live writes and dead-tail constants against
    kernels/ref.py, every output bit for bit: int16 / int32 / int64 and
    delta columns, cap_in = 0, zero-size lanes, totals past cap_out, a
    lane spanning many tiles, tiles spanning many lanes."""
    g, base, sizes, cap_out = _k3_case(case)
    store = g.col_store
    if case in ("int16", "int32", "int64"):
        assert store.dtype == getattr(torch, case)
    ro = g.row_offsets.numpy().astype(np.int64)
    got = lb_tiles_model(sizes, cap_out, threads,
                         np.random.default_rng(threads),
                         (ro, base, _cols_reader(store), g.num_edges))
    b = base.shape[0]
    if case == "cap_in_0":
        # no input lane: the plain version refuses the shape in its
        # gathers; every slot is dead, in_pos 0
        want = [np.full((b, cap_out), v) for v in (-1, -1, -1, 0, 0)] + [
            np.zeros((b, cap_out), bool), np.zeros(b)]
    else:
        want = [t.numpy() for t in P.advance_batch(
            g.row_offsets, store, torch.from_numpy(base),
            torch.from_numpy(sizes), cap_out)]
    for i, (x, y) in enumerate(zip(got, want)):
        assert np.array_equal(x, y), i
    if case == "clamped":
        assert (sizes.sum(axis=1) > cap_out).any()


@pytest.mark.parametrize("case", ["int16", "int32", "clamped", "long_lane"])
def test_advance_model_matches_reference_kernel(case):
    """The same model against the JAX package's advance_fused_batch_kernel
    (the "advance_batch" pallas provider, interpret mode on the CPU)."""
    from repro.core import backend as JB
    g, base, sizes, cap_out = _k3_case(case)
    cols = g.col_store.numpy()
    ro = g.row_offsets.numpy()
    got = lb_tiles_model(sizes, cap_out, 256, np.random.default_rng(0),
                         (ro.astype(np.int64), base,
                          lambda e, s: cols[e].astype(np.int64),
                          g.num_edges))
    want = JB.dispatch("advance_batch", "pallas")(
        jnp.asarray(ro), jnp.asarray(cols), jnp.asarray(base),
        jnp.asarray(sizes), cap_out)
    for i, (x, y) in enumerate(zip(got, want)):
        assert np.array_equal(x, np.asarray(y)), i


def _k6_sizes(case):
    rng = np.random.default_rng(len(case))
    if case == "cap_in_0":
        return np.zeros(0, np.int32), 4097
    sizes = rng.integers(0, 9, 3000).astype(np.int32)
    sizes[rng.random(3000) < 0.4] = 0                 # zero-size segments
    cap_out = int(sizes.sum()) + 777                  # slots past the total
    if case == "clamped":
        cap_out = int(sizes.sum()) // 3
    elif case == "many_lanes":
        sizes = (rng.random(3 * K.SCAN_TILE + 77) < 0.05).astype(np.int32)
        sizes[2000:9000] = 0
        cap_out = int(sizes.sum()) + 5
    elif case == "long_lane":
        sizes[11] = 5 * K.LB_TILE_SLOTS + 3
        sizes[-1] = 0                                 # a trailing empty one
        cap_out = int(sizes.sum()) + 999
    return sizes, cap_out


K6_CASES = ["zero_lanes", "cap_in_0", "clamped", "many_lanes", "long_lane"]


@pytest.mark.parametrize("threads", [64, 256, 1024])
@pytest.mark.parametrize("case", K6_CASES)
def test_lb_expand_model_matches_plain_version(case, threads):
    """K6's scan, partition, live writes and dead tail (in_pos cap_in - 1,
    rank slot - offsets[cap_in - 1]) against kernels/ref.py on every
    slot."""
    sizes, cap_out = _k6_sizes(case)
    got = lb_tiles_model(sizes[None], cap_out, threads,
                         np.random.default_rng(threads))
    want = K.lb_expand(torch.from_numpy(sizes), cap_out)
    for i, (x, y) in enumerate(zip(got, want)):
        assert np.array_equal(x, y.numpy()), i


@pytest.mark.parametrize("case", K6_CASES)
def test_lb_expand_model_matches_reference_kernel(case):
    """The same model against the JAX package's lb_expand_kernel
    (interpret mode on the CPU) and its oracle."""
    sizes, cap_out = _k6_sizes(case)
    got = lb_tiles_model(sizes[None], cap_out, 128,
                         np.random.default_rng(1))
    want = JK.lb_expand(jnp.asarray(sizes), cap_out)
    for i, (x, y) in enumerate(zip(got, want)):
        assert np.array_equal(x, np.asarray(y)), i


# ---- K5: warp rows of 32 lanes, a thread's searches interleaved ---------

def search_model(hay: np.ndarray, lo, hi, needles, locate: bool, rng,
                 stats: dict = None) -> np.ndarray:
    """K5 as the card runs it (csrc/search.cu): chunks of 32 · V lanes in
    a random order, row j of a chunk lanes base + 32 j + lane (a thread
    carries its V rows); the clamp skipped in a warp whose lanes with a
    segment all lie inside [0, m) (and every such read checked to fall
    inside); the searches in rounds, one read a live lane a round; the
    answer from the value read where a search last moved hi (l < hi).
    ``stats`` counts lanes by path: "fast", "clamped", "empty" (no
    segment: lo >= hi, or m = 0)."""
    m, cap = len(hay), len(needles)
    hay = hay.astype(np.int64)
    chunk = 32 * K.SEARCH_LANES
    out = np.full(cap, 12345, np.int64)         # torch.empty
    for base in rng.permutation(-(-cap // chunk)) * chunk:
        i = np.arange(base, min(base + chunk, cap))
        l = lo[i].astype(np.int64)
        h0 = hi[i].astype(np.int64)
        x = needles[i].astype(np.int64)
        h = np.where((m > 0) & (l < h0), h0, l)   # no segment: no reads
        fast = bool(np.all((l >= h) | ((l >= 0) & (h <= m))))
        hv = np.zeros(len(i), np.int64)
        while True:                              # one round
            live = l < h
            if not live.any():
                break
            mid = l + ((h - l) >> 1)
            if fast:
                assert (mid[live] >= 0).all() and (mid[live] < m).all()
                val = hay[np.where(live, mid, 0)]
            else:
                val = hay[np.clip(mid, 0, max(m - 1, 0))]
            right = live & (val < x)
            left = live & ~(val < x)
            l = np.where(right, mid + 1, l)
            h = np.where(left, mid, h)
            hv = np.where(left, val, hv)
        found = (m > 0) & (l < h0) & (hv == x)
        out[i] = np.where(found, l, -1) if locate else found
        if stats is not None:
            seg = (m > 0) & (lo[i] < hi[i])
            path = "fast" if fast else "clamped"
            stats[path] = stats.get(path, 0) + int(seg.sum())
            stats["empty"] = stats.get("empty", 0) + int((~seg).sum())
    return out.astype(np.int32) if locate else out.astype(bool)


@pytest.mark.parametrize("dtype", ["int16", "int32", "int64"])
@pytest.mark.parametrize("case", K5_CASES)
def test_search_model_matches_plain_version(case, dtype):
    """K5's rows against kernels/ref.py's segment_search and
    segment_locate on every lane, at each haystack dtype: runs sharing a
    segment, runs broken by lanes of another segment, a run over many
    chunks and chunks of many runs, a hub segment, segments of 0 and 1
    entries and lo >= hi, unsorted segments with descending needles,
    lo / hi outside [0, m), an empty haystack, and needles below and
    above every value."""
    hay, lo, hi, nd = k5_case(case)
    if dtype == "int16" and case == "hub":
        hay, nd = hay // 32, (nd // 32).astype(np.int32)   # still sorted
    hay = hay.astype(dtype)
    t = [torch.from_numpy(a) for a in (hay, lo, hi, nd)]
    stats = {}
    rng = np.random.default_rng(len(case))
    found = search_model(hay, lo, hi, nd, False, rng, stats=stats)
    pos = search_model(hay, lo, hi, nd, True, rng)
    assert np.array_equal(found, P.segment_search(*t).numpy())
    assert np.array_equal(pos, P.segment_locate(*t).numpy())
    assert all(stats.get(w, 0) > 0 for w in K5_PATHS[case]), stats
    if case not in ("empty", "extremes"):
        assert 0 < found.sum() < len(found)


@pytest.mark.parametrize("locate", [False, True], ids=["found", "locate"])
@pytest.mark.parametrize("case", K5_CASES)
def test_search_model_matches_reference_kernel(case, locate):
    """The same model against the JAX package's segment_search_kernel in
    interpret mode and its xla provider's plain search (int32 haystack;
    an empty one against the contract, nothing found, which the
    kernel's whole-haystack block cannot take)."""
    from repro.core import operators as JO
    from repro.kernels.segment_search import segment_search_kernel
    hay, lo, hi, nd = k5_case(case)
    hay = hay.astype(np.int32)
    got = search_model(hay, lo, hi, nd, locate, np.random.default_rng(5))
    j = [jnp.asarray(a) for a in (hay, lo, hi, nd)]
    if case == "empty":
        want = np.full(len(nd), -1 if locate else 0)
    else:
        want = np.asarray(segment_search_kernel(*j, interpret=True,
                                                locate=locate))
        assert np.array_equal(want, np.asarray(JO._searchsorted_segment(
            *j, locate=locate)).astype(np.int32))
    assert np.array_equal(got.astype(np.int32), want)


@pytest.mark.parametrize("cap", [1, 127, 128, 129, 1000])
def test_search_model_rows_cover_every_lane(cap):
    """Chunks of 32 · SEARCH_LANES lanes cover every lane once, at caps
    below, at and past one chunk (the model writes each lane once over
    an output that starts as garbage)."""
    hay, lo, hi, nd = (a[:cap] if len(a) > 1000 else a
                       for a in k5_case("shared"))
    got = search_model(hay, lo, hi, nd, True, np.random.default_rng(cap))
    want = P.segment_locate(*(torch.from_numpy(a)
                              for a in (hay, lo, hi, nd))).numpy()
    assert len(got) == cap and np.array_equal(got, want)
