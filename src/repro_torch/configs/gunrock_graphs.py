"""The paper's own workload configs (Table 4), CPU-scaled (counterpart
of ``repro.configs.gunrock_graphs``, on the port's generators).

Each entry maps a paper dataset to a generator recipe of the same family
(scale-free social / web-crawl / generated R-MAT with Graph500
initiators / random geometric / road mesh), at sizes this container can
run. `scaled_by` records the size reduction vs the paper's graph.
"""
from __future__ import annotations

from repro_torch.core import graph as G

PAPER_DATASETS = {
    # paper name          family        generator                     scaled_by
    "soc-orkut": dict(
        family="real scale-free social",
        make=lambda device=None: G.rmat(
            14, 16, seed=101, weighted=True, device=device),
        paper_nm=(3.0e6, 212.7e6), scaled_by="~800x"),
    "soc-livejournal1": dict(
        family="real scale-free social",
        make=lambda device=None: G.rmat(
            14, 8, seed=102, weighted=True, device=device),
        paper_nm=(4.8e6, 85.7e6), scaled_by="~650x"),
    "hollywood-09": dict(
        family="real scale-free collab",
        make=lambda device=None: G.rmat(
            13, 16, seed=103, weighted=True, device=device),
        paper_nm=(1.1e6, 112.8e6), scaled_by="~860x"),
    "indochina-04": dict(
        family="web crawl (very skewed)",
        make=lambda device=None: G.rmat(
            14, 8, a=0.65, b=0.15, c=0.15, seed=104, weighted=True,
            device=device),
        paper_nm=(7.4e6, 302e6), scaled_by="~2300x"),
    "rmat_s22_e64": dict(
        family="generated R-MAT (Graph500 initiators)",
        make=lambda device=None: G.rmat(
            14, 32, seed=105, weighted=True, device=device),
        paper_nm=(4.2e6, 483e6), scaled_by="~920x"),
    "rmat_s23_e32": dict(
        family="generated R-MAT",
        make=lambda device=None: G.rmat(
            15, 16, seed=106, weighted=True, device=device),
        paper_nm=(8.4e6, 505.6e6), scaled_by="~960x"),
    "rmat_s24_e16": dict(
        family="generated R-MAT",
        make=lambda device=None: G.rmat(
            16, 8, seed=107, weighted=True, device=device),
        paper_nm=(16.8e6, 519.7e6), scaled_by="~990x"),
    "rgg_n_24": dict(
        family="random geometric (mesh-like)",
        make=lambda device=None: G.random_geometric(
            1 << 14, 0.013, seed=108, weighted=True, device=device),
        paper_nm=(16.8e6, 265.1e6), scaled_by="~1000x"),
    "roadnet_USA": dict(
        family="road network (mesh-like)",
        make=lambda device=None: G.grid2d(
            128, weighted=True, seed=109, device=device),
        paper_nm=(23.9e6, 577.1e6), scaled_by="~1400x"),
}


def make_paper_dataset(name: str, device=None):
    """The dataset's graph on ``device`` (None: the card)."""
    return PAPER_DATASETS[name]["make"](device)
