"""Each metric reader on a recorded fixture, the trace's reduction, and
the roofline counting rules."""
import pytest
import torch

import pbtest_util as U
from pb import roofline, spec, trace

READERS = spec.readers(U.REPO, [{"name": p.stem} for p in
                                (U.BENCH / "metrics").glob("*.py")])

REC = {"setup_s": 61.5, "build_s": 40.25, "window_s": 10.0,
       "records": [{"status": "ok", "lat_ms": float(i)}
                   for i in range(1, 101)] + [{"status": "error",
                                               "lat_ms": 1e6}],
       "flushes": [{"flush_ms": 100.0, "copy_ms": 25.0},
                   {"flush_ms": 300.0, "copy_ms": 25.0}],
       "host_reads": 30, "busy_s": 8.0, "glue_s": 4.0,
       "kernel_s": {"af_expand": 1.0, "af_emit": 0.5, "lb_offsets": 0.25,
                    "lb_expand_tiles": 0.25, "cp_kernel": 0.0,
                    "spmm_rows": 2.0},
       "calls": {"advance_filter_batch": [(3.35e12 * 0.5, 0)],
                 "advance_batch": [(3.35e12 * 0.25, 0)],
                 "compact": [(0, 67e12 * 0.25)],
                 "spmm": [(3.35e12 * 0.5, 0)]}}

WANT = {"qps": 10.0, "p95_ms": 95.05, "setup_s": 61.5, "build_s": 40.25,
        "copy_share": 12.5, "host_reads_per_flush": 15.0,
        "glue_share": 50.0, "idle_share": 20.0,
        "roofline.traverse": 50.0, "roofline.reach": 25.0}


def test_every_metric_of_the_benchmark_has_a_reader():
    import json
    bench = json.loads((U.REPO / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert names <= set(READERS) == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_fixture(name):
    assert READERS[name].read(REC) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["glue_share", "idle_share",
                                  "roofline.traverse", "roofline.reach"])
def test_device_readers_find_nothing_without_a_trace(name):
    rec = dict(REC, busy_s=0.0, kernel_s={}, calls={})
    assert READERS[name].read(rec) is None


def test_summarize_events():
    kernels = frozenset({"af_expand"})
    dev = [(0, 100, "void af_expand<256, X>(int const*)"),
           (50, 150, "Memcpy DtoH (Device -> Pageable)"),
           (300, 400, "void at::native::elementwise_kernel<4>(int)"),
           (1000, 1100, "void af_expand<256, X>(int const*)")]
    host = [(140, 310, "aten::copy_"), (500, 900, "serve_mixed"),
            (600, 650, "aten::item")]
    s = trace.summarize_events(dev, host, kernels)
    assert s["busy_s"] == pytest.approx(350e-9)
    assert s["kernel_s"]["af_expand"] == pytest.approx(200e-9)
    assert s["glue_s"] == pytest.approx(100e-9)
    assert s["idle_gaps"] == [[trace.IN_PYTHON, pytest.approx(600e-9)],
                              ["aten::copy_", pytest.approx(150e-9)]]
    assert s["device_ops"][0][0].startswith("void af_expand")


def test_program_kernels_from_the_sources():
    from repro_torch.kernels import runtime
    names = trace.program_kernels(runtime.CSRC)
    assert {"af_expand", "af_emit", "lb_offsets", "lb_expand_tiles",
            "cp_kernel", "spmm_rows", "spmv_rows"} <= names
    assert trace.base_name("void af_emit<256, DenseCols<int> >(int const*"
                           ")") == "af_emit"
    assert trace.base_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def test_counting_rules():
    sizes = torch.tensor([[3, 0, 2], [0, 0, 9]], dtype=torch.int32)
    # K1: 2 lanes x 3 inputs, 3 live, slots min(5, 8) + min(9, 8) = 13
    assert roofline.advance_filter_batch(
        (None, None, None, sizes, None, 8, 16), {}, None) == (
        2 * 3 * 4 + 3 * 8 + 13 * 5 + 2 * 16 * 8 + 2 * 8, 13 * 8)
    assert roofline.advance_batch((None, None, None, sizes, 8), {}, None) == (
        2 * 3 * 4 + 3 * 8 + 13 * 4 + 2 * 8 * 21 + 2 * 4, 2 * 8 * 4)
    mask = torch.tensor([[True, False, True], [False, False, False]])
    values = torch.arange(3, dtype=torch.int32)[None, :]
    assert roofline.compact((values, mask), {}, None) == (
        3 * 4 + 6 + 2 * 4 + 2 * 4, 2 * 3 * 4)
    offsets = torch.tensor([0, 2, 5, 5, 6], dtype=torch.int32)
    x = torch.zeros((4, 32))
    need = torch.tensor([True, False, True, True])
    assert roofline.spmm((offsets, None, None, x, None, 0, need), {},
                         None) == (5 * 4 + 4 + 3 * 4 + 2 * 4 * 32 * 4,
                                   2 * 3 * 32)
