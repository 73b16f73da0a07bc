"""The port's GRU recurrence (repro_torch.kernels.gru_scan) against the JAX package.

On the CPU the wrappers run their plain versions; they are held against the
Pallas kernels in interpret mode (as tests/test_kernel_backward.py runs
them) and against the jnp references, on the same numpy inputs.  The CUDA
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: 1e-5 in float32.  The weight cotangents dW_hh / db_hh are sums
over B*T terms taken in another order, so they are held to 1e-5 times
max(1, max|ref|), the scale tests/test_kernel_backward.py uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.gru_scan import kernel as jax_kernel  # noqa: E402
from repro.kernels.gru_scan.ops import gru_scan_op  # noqa: E402
from repro.kernels.gru_scan.ref import gru_scan_bwd_ref as jax_bwd_ref  # noqa: E402
from repro.kernels.gru_scan.ref import gru_scan_ref as jax_fwd_ref  # noqa: E402
from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ops import GRUScan, gru_sequence  # noqa: E402
from repro_torch.kernels.gru_scan.ref import gru_scan_ref  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = [(1, 1, 1), (3, 7, 2), (5, 3, 8), (130, 5, 4), (16, 24, 32)]


def inputs(b, t, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(*lead, b, t, 3 * n)).astype(np.float32)
    w = (rng.normal(size=(*lead, n, 3 * n)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(*lead, 3 * n)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(*lead, b, t, n)).astype(np.float32)
    return xg, w, bias, dy


def t_(*arrays, device="cpu"):
    return [torch.tensor(np.asarray(a)).to(device) for a in arrays]


def close(got, ref, tol=TOL, scaled=False):
    got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    bound = tol * max(1.0, float(np.max(np.abs(ref)))) if scaled else tol
    assert float(np.max(np.abs(got - ref))) <= bound


@pytest.mark.parametrize("b,t,n", SHAPES)
def test_forward_matches_pallas_and_jnp_reference(b, t, n):
    xg, w, bias, _ = inputs(b, t, n)
    got = kernel.gru_scan(*t_(xg, w, bias))
    close(got, jax_kernel.gru_scan(xg, w, bias, interpret=True))
    close(got, jax_fwd_ref(xg, w, bias))
    close(gru_scan_ref(*t_(xg, w, bias)), jax_fwd_ref(xg, w, bias))


@pytest.mark.parametrize("b,t,n", SHAPES)
def test_backward_matches_pallas_and_jnp_reference(b, t, n):
    xg, w, bias, dy = inputs(b, t, n, seed=1)
    h = np.asarray(jax_fwd_ref(xg, w, bias))
    got = kernel.gru_scan_bwd(*t_(xg, w, bias, h, dy))
    for ref in (
        jax_kernel.gru_scan_bwd(xg, w, bias, h, dy, interpret=True),
        jax_bwd_ref(xg, w, bias, h, dy),
    ):
        close(got[0], ref[0])
        close(got[1], ref[1], scaled=True)
        close(got[2], ref[2], scaled=True)


@pytest.mark.parametrize("b,t,n", [(3, 7, 2), (130, 5, 4)])
def test_autograd_matches_jax_grad(b, t, n):
    xg, w, bias, cot = inputs(b, t, n, seed=2)
    ref = jax.grad(
        lambda a, b_, c: jnp.sum(gru_scan_op(a, b_, c) * cot), argnums=(0, 1, 2)
    )(xg, w, bias)
    leaves = [x.requires_grad_(True) for x in t_(xg, w, bias)]
    h = GRUScan.apply(*leaves)
    got = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), leaves)
    close(got[0], ref[0])
    close(got[1], ref[1], scaled=True)
    close(got[2], ref[2], scaled=True)


def test_gru_sequence_grads_match_jax():
    from repro.kernels.gru_scan.ops import gru_sequence as jax_gru_sequence

    rng = np.random.default_rng(3)
    b, t, f, n = 6, 5, 4, 3
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    w_ih = (rng.normal(size=(f, 3 * n)) * 0.3).astype(np.float32)
    b_ih = (rng.normal(size=(3 * n,)) * 0.1).astype(np.float32)
    _, w_hh, b_hh, cot = inputs(b, t, n, seed=4)
    args = (x, w_ih, w_hh, b_ih, b_hh)
    ref_h = jax_gru_sequence(*args)
    ref = jax.grad(lambda *a: jnp.sum(jax_gru_sequence(*a) * cot), argnums=(0, 1, 2, 3, 4))(*args)
    leaves = [a.requires_grad_(True) for a in t_(*args)]
    h = gru_sequence(*leaves)
    close(h, ref_h)
    got = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), leaves)
    for g, r in zip(got, ref):
        close(g, r, scaled=True)


def test_client_axis_matches_per_client_loop():
    c, b, t, n = 3, 5, 4, 2
    xg, w, bias, dy = inputs(b, t, n, seed=5, lead=(c,))
    h = kernel.gru_scan(*t_(xg, w, bias))
    dxg, dw, db = kernel.gru_scan_bwd(*t_(xg, w, bias, h.numpy(), dy))
    assert h.shape == (c, b, t, n) and dw.shape == (c, n, 3 * n) and db.shape == (c, 3 * n)
    for i in range(c):
        close(h[i], kernel.gru_scan(*t_(xg[i], w[i], bias[i])))
        close(h[i], jax_kernel.gru_scan(xg[i], w[i], bias[i], interpret=True))
        ref = jax_bwd_ref(xg[i], w[i], bias[i], h[i].numpy(), dy[i])
        close(dxg[i], ref[0])
        close(dw[i], ref[1], scaled=True)
        close(db[i], ref[2], scaled=True)


def test_ragged_batch_rows_are_independent():
    # B = 130 is ragged for the Pallas tile (128) and for the CUDA tile (rows
    # = 256 // N); the last rows must equal the same rows run on their own.
    xg, w, bias, _ = inputs(130, 5, 4, seed=6)
    h = kernel.gru_scan(*t_(xg, w, bias))
    close(h[125:], kernel.gru_scan(*t_(xg[125:], w, bias)))


@pytest.mark.parametrize(
    "shapes",
    [
        ((2, 3, 6), (3, 6), (6,)),        # w_hh not (N, 3N)
        ((2, 3, 7), (2, 7), (7,)),        # last dim not a multiple of 3
        ((2, 2, 3, 6), (2, 6), (6,)),     # client axis without per-client weights
        ((2, 2, 3, 6), (3, 2, 6), (3, 6)),  # client counts disagree
    ],
)
def test_wrapper_rejects_bad_shapes(shapes):
    x_shape, w_shape, b_shape = shapes
    with pytest.raises(ValueError):
        kernel.gru_scan(torch.zeros(x_shape), torch.zeros(w_shape), torch.zeros(b_shape))
