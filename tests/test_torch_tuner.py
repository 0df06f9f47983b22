"""The port's kernel tuner (``repro_torch.kernels.tuner``), mirroring the
reference's tuner tests (tests/test_tiered.py): the version-2 cache and
its key, the dense fallback for delta launches, persistence, the
unclamped tier floor, the five probes — and what holds with no cache:
256 threads per block and the ladders the port had before the tuner."""
import json

import pytest
import torch

from repro.kernels import tuner as JT
from repro_torch.core import backend as TB
from repro_torch.core import frontier as TF
from repro_torch.kernels import ops as K
from repro_torch.kernels import runtime, tuner

CPU = torch.device("cpu")


@pytest.fixture
def cache(tmp_path):
    """A cache file the tuner points at for one test; no cache (the
    default) is restored afterwards."""
    path = tmp_path / "cache.json"
    tuner.set_cache(path)
    yield path
    tuner.set_cache(None)


def _write(path, entries, version=2):
    path.write_text(json.dumps({"version": version, "entries": entries}))
    tuner.set_cache(path)          # the entries are read again on set_cache


def test_key_matches_the_reference():
    for op, cap, plat, min_tile, enc in (
            ("advance", 4096, "cpu", 512, "dense"),
            ("spmv", 3, "cuda:sm_90:NVIDIA H100 80GB HBM3", 512, "dense"),
            ("compact", 1 << 31, "cpu", 128, "delta"),
            ("lb_expand", 700, "x", 1024, "dense")):
        assert (tuner._key(op, cap, plat, min_tile, enc)
                == JT._key(op, cap, plat, min_tile, enc))
        assert tuner.tier_of(cap, min_tile) == JT.tier_of(cap, min_tile)
    assert tuner.pow2_ceil(700) == JT.pow2_ceil(700) == 1024


def test_platform_key():
    assert runtime.platform("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert runtime.platform() == "cpu"


def test_default_tile_is_the_untuned_launch_geometry():
    for cap in (1, 40, 512, 1 << 27):
        assert tuner.default_tile(cap) == 256
    tuner.set_cache(None)
    try:
        assert tuner.tile_for("advance", 4096, device=CPU) == 256
    finally:
        tuner.set_cache(None)


def test_spmv_launches_128_threads_untuned(cache):
    """K4's own untuned geometry; a measured entry still wins."""
    tuner.set_cache(None)
    assert tuner.tile_for("spmv", 1 << 22, device=CPU) == 128
    assert tuner.tile_for("advance", 1 << 22, device=CPU) == 256
    _write(cache, {tuner._key("spmv", 4096, "cpu", 512): {"tile": 512}})
    assert tuner.tile_for("spmv", 4096, device=CPU) == 512


def test_candidates_are_block_sizes():
    assert tuner.candidates(40) == [64]
    assert tuner.candidates(512) == [64, 128, 256, 512]
    assert tuner.candidates(131072) == [64, 128, 256, 512, 1024]


def test_cache_round_trip(cache):
    key = tuner._key("advance", 4096, "cpu", 512)
    _write(cache, {key: {"tile": 128}})
    assert tuner.tile_for("advance", 4096, device=CPU) == 128
    # a capacity smaller than the tile gets the smallest block covering it
    _write(cache, {tuner._key("advance", 40, "cpu", 512): {"tile": 512}})
    assert tuner.tile_for("advance", 40, device=CPU) == 64
    # another platform's entry is not read
    _write(cache, {tuner._key("advance", 4096, "cuda:sm_90:x", 512):
                   {"tile": 128}})
    assert tuner.tile_for("advance", 4096, device=CPU) == 256
    # None ignores the cache
    _write(cache, {key: {"tile": 128}})
    tuner.set_cache(None)
    assert tuner.tile_for("advance", 4096, device=CPU) == 256


def test_version_one_cache_is_ignored(cache):
    key = tuner._key("advance", 4096, "cpu", 512)
    _write(cache, {key.rsplit("|", 1)[0]: {"tile": 128}, key: {"tile": 128}},
           version=1)
    assert tuner.tile_for("advance", 4096, device=CPU) == 256
    assert json.loads(cache.read_text())["version"] == 1   # not deleted


def test_delta_borrows_dense_never_the_reverse(cache):
    tier = tuner.tier_of(4096)
    dense, delta = (f"advance|{tier}|cpu|{e}" for e in ("dense", "delta"))
    _write(cache, {dense: {"tile": 512}})
    assert tuner.tile_for("advance", 4096, encoding="delta",
                          device=CPU) == 512
    _write(cache, {dense: {"tile": 512}, delta: {"tile": 128}})
    assert tuner.tile_for("advance", 4096, encoding="delta",
                          device=CPU) == 128
    assert tuner.tile_for("advance", 4096, device=CPU) == 512
    _write(cache, {delta: {"tile": 128}})
    assert tuner.tile_for("advance", 4096, device=CPU) == 256


def test_autotune_persists_the_winner(cache):
    calls = []

    def probe(cap, tile):
        calls.append(tile)
        return 0.001 if tile == 128 else 0.01

    assert tuner.autotune("fake_op", 1024, probe, repeats=1,
                          device=CPU) == 128
    assert sorted(set(calls)) == tuner.candidates(1024)
    data = json.loads(cache.read_text())
    assert data["version"] == 2
    entry = data["entries"][f"fake_op|{tuner.tier_of(1024)}|cpu|dense"]
    assert entry["tile"] == 128 and entry["cap"] == 1024
    # in memory at once, and a second autotune keeps the entry
    calls.clear()
    assert tuner.tile_for("fake_op", 1024, device=CPU) == 128
    assert tuner.autotune("fake_op", 1024, probe, device=CPU) == 128
    assert calls == []
    # read back from the file by a fresh load
    tuner.set_cache(cache)
    assert tuner.tile_for("fake_op", 1024, device=CPU) == 128


def test_autotune_needs_a_cache_file():
    tuner.set_cache(None)
    try:
        with pytest.raises(ValueError, match="cache file"):
            tuner.autotune("fake_op", 512, lambda c, t: 0.0, device=CPU)
    finally:
        tuner.set_cache(None)


def test_tier_floor_is_unclamped(cache):
    key = tuner._key("advance", 512, "cpu", 512)
    _write(cache, {key: {"tile": 1024}})
    assert tuner.tier_floor("advance", 512, device=CPU) == 1024
    assert TB.tier_plan("advance", 8192, device=CPU)[0] == 1024
    _write(cache, {key: {"tile": 128}})
    assert tuner.tier_floor("advance", 512, device=CPU) == 512


def test_five_probes_registered_and_refuse_without_a_card():
    assert sorted(tuner.PROBES) == ["advance", "advance_filter", "compact",
                                    "lb_expand", "spmv"]
    assert "spmm" not in tuner.PROBES
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for op, probe in tuner.PROBES.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe(512, 256)


@pytest.mark.parametrize("cap", [1, 511, 512, 513, 4096, 128_309_080])
def test_tier_plan_without_a_cache_is_the_min_tier_ladder(cap):
    tuner.set_cache(None)
    try:
        for op in ("advance", "advance_filter"):
            assert TB.tier_plan(op, cap, device=CPU) == TF.tier_caps(
                cap, min_tier=TF.MIN_TIER)
            assert TB.tier_plan(op, cap) == TF.tier_caps(cap, 512)
    finally:
        tuner.set_cache(None)


def test_wrappers_refuse_a_bad_block_size():
    with pytest.raises(ValueError, match="power of two"):
        K._threads("advance", 512, CPU, 96)
    with pytest.raises(ValueError, match="power of two"):
        K._threads("advance", 512, CPU, 2048)
    assert K._threads("advance", 512, CPU, None) == 256


def test_cli_writes_the_cache_it_is_given(tmp_path, monkeypatch):
    """Without a card the probes raise, so the CLI stops before writing;
    the cache path it was given is the one set."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = tmp_path / "t.json"
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tuner.main(["--ops", "lb_expand", "--caps", "512",
                        "--cache", str(path)])
        assert tuner.cache_path() == path and not path.exists()
    finally:
        tuner.set_cache(None)


def test_autotune_all_measures_delta_for_probes_that_model_it(cache,
                                                              monkeypatch):
    """A probe with an ``encoding`` parameter is measured once per
    encoding and its picks land under both keys (the reference's
    autotune_all); a probe without one is measured dense only."""
    seen = []

    def coded(cap, tile, encoding="dense"):
        seen.append(encoding)
        return 0.001 if (tile == 128) == (encoding == "delta") else 0.01

    def plain(cap, tile):
        return 0.001 if tile == 64 else 0.01

    monkeypatch.setattr(tuner, "PROBES", {"coded": coded, "plain": plain})
    picked = tuner.autotune_all([1024], device=CPU)
    assert picked == {("coded", 1024, "dense"): 64,
                      ("coded", 1024, "delta"): 128,
                      ("plain", 1024, "dense"): 64}
    assert set(seen) == {"dense", "delta"}
    assert tuner.tile_for("coded", 1024, encoding="delta", device=CPU) == 128
    assert tuner.tile_for("coded", 1024, device=CPU) == 64
    assert tuner.entry("coded", 1024, CPU, encoding="delta")["tile"] == 128
    # the port's advance probes model the encoding, as the reference's do
    for op in ("advance", "advance_filter"):
        assert tuner._takes_encoding(K.__dict__[f"_probe_{op}"])
    assert not tuner._takes_encoding(K._probe_spmv)
