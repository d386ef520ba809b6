"""The exact scan's least time at the cells' shapes."""

import pytest

from benchmark import roofline


def test_flat_batch_bound_by_operations():
    t, by = roofline.exact_scan(512, 1_000_000, 768, 10)
    assert by == "operations" and t * 1e3 == pytest.approx(1.589, abs=5e-4)


def test_mesh_card_bound_by_operations():
    t, by = roofline.exact_scan(512, 20_000_000, 768, 10)
    assert by == "operations" and t * 1e3 == pytest.approx(31.78, abs=5e-3)


def test_single_query_bound_by_bytes():
    t, by = roofline.exact_scan(1, 1_000_000, 768, 10)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.917, abs=5e-4)


def _run(ops_by_card, calls=10, window_s=1.0, latencies=100):
    import numpy as np

    from benchmark.harness import Run

    trace = {"calls": calls, "ops_by_card": ops_by_card,
             "busy_by_card": {c: sum(o.values()) for c, o in ops_by_card.items()},
             "window_s": window_s}
    return Run(shape={"batch": 512, "rows_per_card": 1_000_000, "dims": 768, "k": 10,
                      "elem_bytes": 4},
               setup_s=1.0, ingest_s=None, window_s=window_s, answered=0,
               latencies_s=np.full(latencies, window_s / latencies), spans={}, trace=trace)


K1 = "void (anonymous namespace)::wg::scan_kernel<(anonymous namespace)::wg::Tf32x3, 64>"
K2 = "void (anonymous namespace)::gr::group_rescore<float, false, true>(float const*)"
NORM = "void at::native::reduce_kernel<512, 1, NormTwoOps<float>>"


def test_scan_roofline_counts_the_scan_kernels_alone():
    """The share's time is K1 and K2 on the card where they ran longest:
    other operations (a norm pass, copies) do not lower it."""
    from benchmark.layer_metrics._read import scan_roofline

    least = roofline.exact_scan(512, 1_000_000, 768, 10)[0]
    run = _run({0: {K1: 0.05, K2: 0.01, NORM: 0.5}, 1: {K1: 0.02, K2: 0.01}})
    assert scan_roofline(run) == pytest.approx(100 * least / 0.006)
    assert scan_roofline(_run({0: {NORM: 0.5}})) is None


def test_step_mfu_is_the_whole_call():
    from benchmark.layer_metrics._read import step_mfu

    least = roofline.exact_scan(512, 1_000_000, 768, 10)[0]
    run = _run({0: {K1: 0.05}}, window_s=2.0, latencies=400)
    assert step_mfu(run) == pytest.approx(100 * least / 0.005)
