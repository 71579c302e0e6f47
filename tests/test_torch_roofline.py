"""The port's roofline (``repro_torch.launch.roofline``): a pipeline's
efficiency stays in [0, 1] and its flops and bytes are the sums of its
launches'.

The reference's ``composite_roofline`` divides the summed flops by the
peak and then by the summed costs; rounding can lift that above 1 (its
own property test, ``tests/test_perf_models.py``, finds such draws).  The
port sums each launch's ideal time in the order it sums the costs.
"""
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.launch import roofline

# two launches bound by their compute at full occupancy, whose flops summed
# then divided by the peak round above the two costs summed
ROUNDS_OVER = [569204305618.3374, 802265258903.1223]


def _parts(draws):
    return [{"flops": f, "hbm_bytes": b, "util": u, "n_steps": n}
            for f, b, u, n in draws]


def test_composite_efficiency_is_one_where_the_summed_division_rounds_over():
    parts = _parts([(f, 1.0, 1.0, 1) for f in ROUNDS_OVER])
    assert sum(ROUNDS_OVER) / roofline.F32_PEAK_FLOPS / sum(
        f / roofline.F32_PEAK_FLOPS for f in ROUNDS_OVER) > 1.0
    roof = roofline.composite_roofline(parts)
    assert roof["efficiency"] == 1.0
    assert roof["flops"] == sum(ROUNDS_OVER)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.floats(1e6, 1e12), st.floats(1.0, 1e9),
                          st.floats(0.05, 1.0), st.integers(0, 1000)),
                min_size=1, max_size=6),
       st.floats(0.0, 1e9),
       st.sampled_from([roofline.F32_PEAK_FLOPS, roofline.TF32_PEAK_FLOPS,
                        roofline.BF16_PEAK_FLOPS]))
def test_composite_roofline_efficiency_and_conservation(draws, extra, peak):
    parts = _parts(draws)
    roof = roofline.composite_roofline(parts, extra_hbm_bytes=extra,
                                       peak=peak)
    assert 0.0 < roof["efficiency"] <= 1.0
    assert roof["launches"] == len(parts)
    assert roof["n_steps"] == sum(p["n_steps"] for p in parts)
    assert roof["flops"] == pytest.approx(sum(p["flops"] for p in parts),
                                          rel=1e-15)
    assert roof["hbm_bytes"] == pytest.approx(
        extra + sum(p["hbm_bytes"] for p in parts), rel=1e-15)
    solo = max(roofline.kernel_roofline(
        flops=p["flops"], hbm_bytes=p["hbm_bytes"], util=p["util"],
        peak=peak)["cost_s"] for p in parts)
    assert roof["cost_s"] >= solo


@settings(max_examples=100, deadline=None)
@given(st.floats(1e6, 1e12), st.floats(1.0, 1e9), st.floats(0.05, 1.0))
def test_kernel_roofline_efficiency_in_unit_interval(flops, nbytes, util):
    roof = roofline.kernel_roofline(flops=flops, hbm_bytes=nbytes, util=util)
    assert 0.0 < roof["efficiency"] <= 1.0
    assert roof["cost_s"] == max(roof["compute_s"], roof["memory_s"])
