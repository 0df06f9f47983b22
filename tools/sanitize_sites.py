"""Every kernel launch site once, at small shapes, for NVIDIA's
``compute-sanitizer`` to watch.

  python tools/sanitize_sites.py [--scale 15]
  compute-sanitizer --tool memcheck --error-exitcode 9 \
      python tools/sanitize_sites.py

Builds ``rmat(scale, 16, seed=0, weighted)`` on the card and calls each
of the 11 declared launch sites of ``kernels/ops.py::_SITES`` under the
port's own launch audit (``analysis.sanitize.sanitizing``): bfs_batch
(K1 and K2), sssp_batch (K3), pagerank (K4), reach_batch (K4m),
triangle_count (K3 at B = 1 and K5 in locate mode), K5 in found mode,
lb_expand (K6), and the kernel API's small attention and MoE cases —
flash_attention, its split form's partials (K7) and combine (K7c), and
moe_gather (K8). Each result is held against the same call on the
plain ``torch`` backend or the kernel's plain version (integers equal,
floats within the kernels' stated tolerances). Fails unless every site
was audited and every kernel launched. Run it bare to check it, then
under each sanitizer tool (memcheck, racecheck, initcheck — K1's
first-slot table among the buffers it watches — and synccheck, over
``lb_tiles.cuh``'s block-wide steps).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=15)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE / "src"))
    import torch

    from repro_torch.analysis import sanitize
    from repro_torch.core import graph as G
    from repro_torch.core.primitives import (bfs_batch, pagerank,
                                             reach_batch, sssp_batch,
                                             triangle_count)
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import runtime

    dev = runtime.resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    runtime.build()
    g = G.rmat(args.scale, 16, seed=0, weighted=True, device=dev)
    deg = g.degrees
    srcs = [int(torch.argmax(deg))] + [int(v) for v in torch.nonzero(
        deg > 0).reshape(-1)[:3].tolist()]
    gen = torch.Generator(device=dev).manual_seed(0)
    K.reset_launches()
    sanitize.reset_audits()
    checks = []

    def same(name, a, b, exact=True):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            if not isinstance(x, torch.Tensor):
                continue
            ok = (torch.equal(x, y) if exact else
                  torch.allclose(x.float(), y.float(), rtol=1e-5, atol=1e-6))
            if not ok:
                raise AssertionError(f"{name}: the kernel's result differs "
                                     f"from the plain one")
        checks.append(name)

    with sanitize.sanitizing():
        same("bfs_batch", bfs_batch(g, srcs, backend="cuda"),
             bfs_batch(g, srcs, backend="torch"))
        same("sssp_batch", sssp_batch(g, srcs, backend="cuda"),
             sssp_batch(g, srcs, backend="torch"))
        same("pagerank", pagerank(g, max_iter=5, backend="cuda"),
             pagerank(g, max_iter=5, backend="torch"), exact=False)
        same("reach_batch", reach_batch(g, srcs, 3, backend="cuda"),
             reach_batch(g, srcs, 3, backend="torch"))
        same("triangle_count", triangle_count(g, backend="cuda"),
             triangle_count(g, backend="torch"))
        ro, ci = g.row_offsets, g.col_indices
        rows = torch.randint(0, g.num_vertices, (1 << 16,), generator=gen,
                             device=dev, dtype=torch.int32)
        lo, hi = ro[rows.long()], ro[rows.long() + 1]
        needles = torch.randint(0, g.num_vertices, rows.shape,
                                generator=gen, device=dev,
                                dtype=torch.int32)
        same("segment_search (found)",
             K.segment_search(ci, lo, hi, needles).to(torch.int32),
             P.segment_search_ref(ci, lo, hi, needles))
        sizes = deg.to(torch.int32).contiguous()
        cap = 1 << max(g.num_edges - 1, 1).bit_length()
        exp = K.lb_expand(sizes, cap)
        same("lb_expand", (exp.in_pos, exp.rank, exp.valid.to(torch.int32)),
             P.lb_expand_ref(P.lb_offsets(sizes), cap))
        q, k, v = (torch.randn((n, 128), generator=gen, device=dev).to(
            torch.bfloat16) for n in (128, 1024, 1024))
        want = P.flash_attention_ref(q, k, v, causal=True).float()
        got = K.flash_attention(q, k, v, causal=True).float()
        parts = K.attention_partials(q, k, v, True, 4)
        split = K.attention_combine(*parts, torch.bfloat16).float()
        for name, out in (("flash_attention", got), ("attention_split",
                                                     split)):
            if not torch.allclose(out, want, rtol=8e-3, atol=1e-4):
                raise AssertionError(f"{name}: beyond one bf16 rounding")
            checks.append(name)
        x = torch.randn((256, 1024), generator=gen, device=dev).to(
            torch.bfloat16)
        slot = torch.randint(-1, 257, (1024,), generator=gen, device=dev,
                             dtype=torch.int32)
        same("moe_gather", K.moe_gather(x, slot), P.moe_gather_ref(x, slot))
    torch.cuda.synchronize()

    sites = sorted({site for site, _ in sanitize.audits()})
    launches = {name: k.launches for name, k in K.KERNELS.items()}
    if sites != sorted(K.SITES) or not all(launches.values()):
        raise AssertionError(f"sites audited {sites}, launches {launches}")
    print(f"rmat scale {args.scale}: {len(sites)} sites audited, "
          f"launches {launches}; checked {', '.join(checks)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
