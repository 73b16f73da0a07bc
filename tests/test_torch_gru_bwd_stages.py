"""The two stages of the port's GRU backward against the JAX package.

On the card ``gru_scan_bwd`` runs two kernels: the reverse recurrence
(``dx_gates`` and ``dgn = r * da_n``) and the weight cotangents summed over
every (row, step).  Their plain twins in ``repro_torch.kernels.gru_scan.ref``
are composed here and held against the port's ``gru_scan_bwd_ref`` and the
JAX package's Pallas ``gru_scan_bwd`` in interpret mode (as
tests/test_kernel_backward.py runs it), on the same numpy inputs.  The CUDA
stages themselves are held against these twins on the card in
tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: ``dx_gates`` 1e-5; ``dW`` and ``db`` 1e-5 times max(1, max|ref|),
as sums over B*T terms taken in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gru_scan import kernel as jax_kernel  # noqa: E402
from repro.kernels.gru_scan.ref import gru_scan_ref as jax_fwd_ref  # noqa: E402
from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ref import (  # noqa: E402
    gru_bwd_dw_ref,
    gru_bwd_recur_ref,
    gru_scan_bwd_ref,
)

torch.set_num_threads(1)

TOL = 1e-5


def inputs(b, t, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(*lead, b, t, 3 * n)).astype(np.float32)
    w = (rng.normal(size=(*lead, n, 3 * n)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(*lead, 3 * n)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(*lead, b, t, n)).astype(np.float32)
    return xg, w, bias, dy


def close(got, ref, scaled=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    bound = TOL * max(1.0, float(np.max(np.abs(ref)))) if scaled else TOL
    assert float(np.max(np.abs(got - ref))) <= bound


def stages(xg, w, bias, h, dy):
    """dW/db stage over the recurrence stage, on torch tensors of numpy inputs."""
    args = [torch.from_numpy(np.array(a)) for a in (xg, w, bias, h, dy)]
    dx, dgn = gru_bwd_recur_ref(*args)
    dw, db = gru_bwd_dw_ref(args[3], dx, dgn)
    return dx, dgn, dw, db


@pytest.mark.parametrize(
    "b,t,n",
    [(8, 5, 4), (37, 7, 8), (16, 24, 32), (16, 24, 64), (5, 1, 4), (130, 3, 2)],
    ids=["small", "ragged", "paper-width", "n64", "t1", "ragged-tile"],
)
def test_stages_compose_to_pallas_backward(b, t, n):
    xg, w, bias, dy = inputs(b, t, n, seed=b + t + n)
    h = np.asarray(jax_fwd_ref(xg, w, bias))
    dx, dgn, dw, db = stages(xg, w, bias, h, dy)
    ref = jax_kernel.gru_scan_bwd(xg, w, bias, h, dy, interpret=True)
    close(dx, ref[0])
    close(dw, ref[1], scaled=True)
    close(db, ref[2], scaled=True)
    assert dgn.shape == (b, t, n)


@pytest.mark.parametrize("b,t,n", [(8, 5, 4), (37, 7, 8), (16, 24, 32), (5, 1, 4)])
def test_stages_compose_to_plain_backward(b, t, n):
    xg, w, bias, dy = inputs(b, t, n, seed=1)
    h = np.asarray(jax_fwd_ref(xg, w, bias))
    dx, dgn, dw, db = stages(xg, w, bias, h, dy)
    ref = gru_scan_bwd_ref(*(torch.from_numpy(np.array(a)) for a in (xg, w, bias, h, dy)))
    close(dx, ref[0])
    close(dw, ref[1], scaled=True)
    close(db, ref[2], scaled=True)


def test_client_axis_matches_pallas_per_client():
    c, b, t, n = 3, 9, 6, 8
    xg, w, bias, dy = inputs(b, t, n, seed=2, lead=(c,))
    h = np.stack([np.asarray(jax_fwd_ref(xg[i], w[i], bias[i])) for i in range(c)])
    dx, dgn, dw, db = stages(xg, w, bias, h, dy)
    assert dx.shape == (c, b, t, 3 * n) and dgn.shape == (c, b, t, n)
    assert dw.shape == (c, n, 3 * n) and db.shape == (c, 3 * n)
    for i in range(c):
        ref = jax_kernel.gru_scan_bwd(xg[i], w[i], bias[i], h[i], dy[i], interpret=True)
        close(dx[i], ref[0])
        close(dw[i], ref[1], scaled=True)
        close(db[i], ref[2], scaled=True)


def test_dgn_is_the_n_part_of_d_gh():
    """dgn = r * da_n, with r rebuilt from h_{t-1} as the recurrence does."""
    b, t, n = 6, 4, 3
    xg, w, bias, dy = inputs(b, t, n, seed=3)
    h = np.asarray(jax_fwd_ref(xg, w, bias))
    dx, dgn, _, _ = stages(xg, w, bias, h, dy)
    h_prev = np.concatenate([np.zeros_like(h[:, :1]), h[:, :-1]], axis=1)
    gh = h_prev @ w + bias
    r = 1.0 / (1.0 + np.exp(-(xg[..., :n] + gh[..., :n])))
    close(dgn, r * dx.numpy()[..., 2 * n:])


def test_stage_wrappers_run_the_plain_stages_on_cpu():
    b, t, n = 7, 5, 4
    xg, w, bias, dy = inputs(b, t, n, seed=4)
    h = np.asarray(jax_fwd_ref(xg, w, bias))
    args = [torch.from_numpy(np.array(a)) for a in (xg, w, bias, h, dy)]
    before = kernel.gru_scan_bwd.launches
    dx, dgn = kernel.stage_recur(*args)
    dw, db = kernel.stage_dw(args[3], dx, dgn)
    assert kernel.gru_scan_bwd.launches == before
    want = stages(xg, w, bias, h, dy)
    for got, ref in zip((dx, dgn, dw, db), want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize(
    "shapes",
    [
        ((4, 3, 5), (4, 3, 2), (4, 3, 2)),     # dx_gates not (..., 3N)
        ((4, 3, 6), (4, 3, 2), (4, 2, 2)),     # dgn not shaped like h_seq
        ((2, 2, 4, 3, 6), (2, 2, 4, 3, 2), (2, 2, 4, 3, 2)),  # two lead axes
    ],
)
def test_stage_dw_rejects_bad_shapes(shapes):
    dx_shape, h_shape, dgn_shape = shapes
    with pytest.raises(ValueError):
        kernel.stage_dw(torch.zeros(h_shape), torch.zeros(dx_shape), torch.zeros(dgn_shape))


def test_stage_recur_rejects_bad_shapes():
    xg, w, bias, dy = (torch.from_numpy(a) for a in inputs(4, 3, 2))
    with pytest.raises(ValueError):
        kernel.stage_recur(xg, w, bias, torch.zeros(4, 2, 2), dy)
