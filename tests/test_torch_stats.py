"""The port's Welch test (``repro_torch.metrics.stats``) against the JAX
package's, exactly: the same t statistics, p-values and stars on the same
seeded numpy samples, including the degenerate cases."""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.metrics import stats as jax_stats  # noqa: E402
from repro_torch import metrics  # noqa: E402
from repro_torch.metrics import stats  # noqa: E402


def same(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sizes", [(2, 2), (3, 5), (10, 10), (40, 7)])
def test_welch_equals_the_reference(seed, sizes):
    rng = np.random.default_rng([seed, *sizes])
    a = rng.normal(0.0, 1.0 + seed, sizes[0])
    b = rng.normal(0.3 * seed, 1.0, sizes[1])
    got, ref = stats.welch_t_test(a, b), jax_stats.welch_t_test(a, b)
    assert all(same(g, r) for g, r in zip(got, ref))
    assert stats.significance_stars(got[1]) == jax_stats.significance_stars(ref[1])


@pytest.mark.parametrize(
    "a, b",
    [([1.0], [1.0, 2.0]), ([2.0, 2.0], [2.0, 2.0]), ([1.0, 1.0], [3.0, 3.0]), ([0.1, 0.2], [0.1, 0.2])],
)
def test_degenerate_samples_equal_the_reference(a, b):
    got, ref = stats.welch_t_test(a, b), jax_stats.welch_t_test(a, b)
    assert all(same(g, r) for g, r in zip(got, ref))


def test_t_sf_and_stars_equal_the_reference():
    rng = np.random.default_rng(11)
    for t, df in zip(rng.uniform(0.0, 8.0, 200), rng.uniform(1.0, 60.0, 200)):
        assert stats.t_sf(float(t), float(df)) == jax_stats.t_sf(float(t), float(df))
    for p in (float("nan"), 0.0, 0.0099, 0.01, 0.03, 0.0499, 0.05, 0.5, 1.0):
        assert stats.significance_stars(p) == jax_stats.significance_stars(p)


def test_the_metrics_package_exports_them():
    assert metrics.welch_t_test is stats.welch_t_test
    assert metrics.significance_stars is stats.significance_stars
