"""The recompute oracles and ``kernels/analysis.py`` on the CPU.

* ``gru_scan_oracle`` and ``ssd_chunk_scan_oracle`` give the residual ops'
  gradients to 1e-5, and the JAX package's oracles' gradients to 1e-5.
* ``recompute_elimination_report`` holds for both pairs at the shapes where
  the JAX package's report holds (its own test's GRU shape): the residual
  backward makes one recurrence pass, the oracle's makes two (the recompute
  and its transpose), and it dispatches no more ops.  Structurally, the
  residual backward reruns no forward (it enters no forward's range) and
  the oracle's does.
* ``backward_stats`` counts a plain product's backward FLOPs exactly, and
  no kernel launch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import analysis as jax_analysis  # noqa: E402
from repro.kernels.gru_scan.ops import gru_scan_op as jax_gru_op  # noqa: E402
from repro.kernels.gru_scan.ops import gru_scan_oracle as jax_gru_oracle  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunk_scan as jax_ssd_op  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunk_scan_oracle as jax_ssd_oracle  # noqa: E402
from repro_torch.kernels import analysis  # noqa: E402
from repro_torch.kernels.gru_scan.ops import GRUScan, gru_scan_oracle  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_chunk_scan, ssd_chunk_scan_oracle  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
GRU_SHAPES = [(None, 4, 12, 16), (None, 128, 24, 32), (3, 5, 7, 8)]  # C, B, T, N
SSD_SHAPES = [(1, 3, 8, 2, 4, 8), (2, 2, 16, 3, 8, 16)]               # B, NC, L, H, P, N


def gru_inputs(c, b, t, n, seed=7):
    rng = np.random.default_rng(seed)
    lead = () if c is None else (c,)
    return (rng.normal(size=(*lead, b, t, 3 * n)).astype(np.float32),
            (rng.normal(size=(*lead, n, 3 * n)) * 0.3).astype(np.float32),
            (rng.normal(size=(*lead, 3 * n)) * 0.1).astype(np.float32))


def ssd_inputs(b, nc, l_len, h, p, n, seed=3):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.2, size=(b, nc, l_len, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    return (rng.normal(size=(b, nc, l_len, h, p)).astype(np.float32), dt,
            np.cumsum(dt * a, axis=2).astype(np.float32),
            rng.normal(size=(b, nc, l_len, n)).astype(np.float32),
            rng.normal(size=(b, nc, l_len, n)).astype(np.float32))


def grads(fn, arrays, seed=1):
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*inputs)
    dy = torch.from_numpy(np.random.default_rng(seed).normal(size=out.shape).astype(np.float32))
    return [g.numpy() for g in torch.autograd.grad(out, inputs, dy)], dy.numpy()


def jax_grads(fn, arrays, dy):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def assert_close(got, ref):
    for g, r in zip(got, ref):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("shape", GRU_SHAPES, ids=str)
def test_gru_oracle_gradients(shape):
    arrays = gru_inputs(*shape)
    oracle, dy = grads(gru_scan_oracle, arrays)
    residual, _ = grads(GRUScan.apply, arrays)
    assert_close(oracle, residual)
    if shape[0] is None:  # the JAX ops take no client axis
        assert_close(oracle, jax_grads(jax_gru_oracle, arrays, dy))


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_oracle_gradients(shape):
    arrays = ssd_inputs(*shape)
    oracle, dy = grads(ssd_chunk_scan_oracle, arrays)
    residual, _ = grads(ssd_chunk_scan, arrays)
    assert_close(oracle, residual)
    assert_close(oracle, jax_grads(jax_ssd_oracle, arrays, dy))


def check_report(rep, ref, forward, backward, oracle):
    assert rep["recompute_eliminated"] and ref["recompute_eliminated"]
    assert rep["residual_bwd"]["passes"] == {backward: 1}
    assert rep["oracle_bwd"]["passes"] == {forward: 1, f"{oracle}_transpose": 1}
    assert set(rep) == set(ref)
    assert rep["residual_bwd"]["scans"] == ref["residual_bwd"]["scans"] == 1
    assert rep["oracle_bwd"]["scans"] == ref["oracle_bwd"]["scans"] == 2
    for side in ("residual_bwd", "oracle_bwd"):
        assert set(rep[side]["launches"].values()) == {0}  # the CPU runs the plain versions
        assert rep[side]["dot_general_flops"] > 0
    assert rep["residual_bwd"]["weighted_eqns"] <= rep["oracle_bwd"]["weighted_eqns"]


def test_gru_recompute_is_eliminated_as_in_the_reference():
    arrays = gru_inputs(None, 4, 12, 16)
    rep = analysis.recompute_elimination_report(
        GRUScan.apply, gru_scan_oracle, *map(torch.from_numpy, arrays))
    ref = jax_analysis.recompute_elimination_report(
        jax_gru_op, jax_gru_oracle, *map(jnp.asarray, arrays))
    check_report(rep, ref, "gru_scan_ref", "gru_scan_bwd_ref", "gru_scan_oracle")


def test_ssd_recompute_is_eliminated_as_in_the_reference():
    arrays = ssd_inputs(*SSD_SHAPES[0])
    rep = analysis.recompute_elimination_report(
        ssd_chunk_scan, ssd_chunk_scan_oracle, *map(torch.from_numpy, arrays))
    ref = jax_analysis.recompute_elimination_report(
        jax_ssd_op, jax_ssd_oracle, *map(jnp.asarray, arrays))
    check_report(rep, ref, "ssd_chunk_scan_ref", "ssd_chunk_scan_bwd_ref", "ssd_chunk_scan_oracle")


def test_backward_stats_counts_a_product_exactly():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    stats = analysis.backward_stats(lambda x, y: x @ y, a, b)
    # dA = dY B^T (3x7 @ 7x5) and dB = A^T dY (5x3 @ 3x7): 2·3·5·7 FLOPs each
    assert stats.dot_general_flops == 2 * (2 * 3 * 5 * 7)
    assert stats.scans == 0 and stats.passes == {}
    assert set(stats.launches) == set(analysis.KERNELS)
    assert stats.as_dict()["weighted_eqns"] >= 2
