"""The port's SSD backward (repro_torch.kernels.ssd) against the JAX package.

``ssd_chunk_scan_bwd_ref`` is held against the Pallas ``ssd_chunk_scan_bwd``
in interpret mode (called directly, as tests/test_kernels.py calls it) and
against JAX's ``ssd_chunk_scan_bwd_ref``, on the same numpy inputs; the
``SSDChunkScan`` Function's gradients against ``jax.grad`` through JAX's
``ssd_chunk_scan`` and ``ssd_full``.  On the CPU the wrapper and the
Function run the plain versions; the CUDA kernel is held against them on the
card in tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerance: 1e-5 times max(1, max|ref|) in float32 — each cotangent sums up
to L*N and L*P products per element (and dB, dC over the heads), taken in
another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import kernel as jax_kernel  # noqa: E402
from repro.kernels.ssd import ops as jax_ops  # noqa: E402
from repro.kernels.ssd import ref as jax_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel, ops, ref  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
P, N = 8, 16


def chunk_inputs(b, nc, l_len, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, nc, l_len, h, p)).astype(np.float32)
    dtc = np.asarray(jax.nn.softplus(rng.normal(size=(b, nc, l_len, h)).astype(np.float32)))
    a = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    cum = np.cumsum(dtc * a, axis=2).astype(np.float32)
    bm = rng.normal(size=(b, nc, l_len, n)).astype(np.float32)
    cm = rng.normal(size=(b, nc, l_len, n)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    return (x, dtc, cum, bm, cm), dy


def t_(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def close(got, want):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= TOL * max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("l_len", [8, 16])
@pytest.mark.parametrize("h", [1, 4])
def test_bwd_ref_matches_pallas_interpret_and_jax_ref(nc, l_len, h):
    args, dy = chunk_inputs(2, nc, l_len, h, P, N, seed=nc * 100 + l_len + h)
    states = np.asarray(jax_ref.ssd_chunk_states_ref(*args))
    got = ref.ssd_chunk_scan_bwd_ref(*t_(*args, states, dy))
    pallas = jax_kernel.ssd_chunk_scan_bwd(*args, states, dy, interpret=True)
    jnp_ref = jax_ref.ssd_chunk_scan_bwd_ref(*args, states, dy)
    assert len(got) == 5
    for g, a, r in zip(got, pallas, jnp_ref):
        close(g, a)
        close(g, r)
    # The wrapper takes the plain version on CPU tensors and counts nothing.
    before = kernel.ssd_chunk_scan_bwd.launches
    for g, w in zip(kernel.ssd_chunk_scan_bwd(*t_(*args, states, dy)), got):
        assert torch.equal(g, w)
    assert kernel.ssd_chunk_scan_bwd.launches == before


def test_function_grads_match_jax_grad_through_chunk_scan():
    args, dy = chunk_inputs(2, 3, 16, 4, P, N, seed=11)
    want = jax.grad(
        lambda *a: jnp.sum(jax_ops.ssd_chunk_scan(*a) * dy), argnums=(0, 1, 2, 3, 4)
    )(*args)
    leaves = [t.requires_grad_(True) for t in t_(*args)]
    y = ops.ssd_chunk_scan(*leaves)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSDChunkScanBackward"
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("s,chunk", [(37, 16), (5, 8)])
def test_function_grads_match_jax_grad_through_ssd_full(s, chunk):
    """Ragged S pads with zeros; the padded rows get zero dy and no gradient."""
    rng = np.random.default_rng(s)
    b, h = 2, 3
    x = rng.normal(size=(b, s, h, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(b, s, h)).astype(np.float32)))
    a = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    bm = rng.normal(size=(b, s, N)).astype(np.float32)
    cm = rng.normal(size=(b, s, N)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(
        lambda *a_: jnp.sum(jax_ops.ssd_full(*a_, chunk=chunk) * cot), argnums=(0, 1, 2, 3, 4)
    )(x, dt, a, bm, cm)
    leaves = [t.requires_grad_(True) for t in t_(x, dt, a, bm, cm)]
    y = ops.ssd_full(*leaves, chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    for g, w in zip(got, want):
        close(g, w)


def test_strong_decay_does_not_overflow():
    """cum falls by 50 a step: exp(cum_l - cum_m) above the diagonal would be
    exp(+800) and overflow, so the mask must come before the exp."""
    args, dy = chunk_inputs(1, 3, 16, 2, P, N, seed=5)
    x, dtc, _, bm, cm = args
    cum = np.cumsum(np.full_like(dtc, -50.0), axis=2).astype(np.float32)
    args = (x, dtc, cum, bm, cm)
    states = np.asarray(jax_ref.ssd_chunk_states_ref(*args))
    got = ref.ssd_chunk_scan_bwd_ref(*t_(*args, states, dy))
    for g, w in zip(got, jax_kernel.ssd_chunk_scan_bwd(*args, states, dy, interpret=True)):
        close(g, w)
    leaves = [t.requires_grad_(True) for t in t_(*args)]
    grads = torch.autograd.grad((ops.ssd_chunk_scan(*leaves) * torch.from_numpy(dy)).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_forward_saves_states_only_when_a_gradient_is_needed():
    args, _ = chunk_inputs(1, 2, 8, 2, P, N, seed=6)
    plain = t_(*args)
    with torch.inference_mode():
        y0 = ops.ssd_chunk_scan(*plain)
    y1 = ops.ssd_chunk_scan(*plain)
    assert y1.grad_fn is None and torch.equal(y0, y1)
    y2 = ops.ssd_chunk_scan(plain[0].clone().requires_grad_(True), *plain[1:])
    saved = y2.grad_fn.saved_tensors
    assert len(saved) == 6 and tuple(saved[5].shape) == (1, 2, 2, P, N)
    assert torch.equal(saved[5], ref.ssd_chunk_states_ref(*plain))
    assert torch.equal(y2.detach(), y1)


@pytest.mark.parametrize(
    "states_shape,dy_shape",
    [((1, 2, 2, 4, 5), (1, 2, 4, 2, 3)), ((1, 2, 2, 3, 5), (1, 2, 4, 2, 4))],
    ids=["states", "dy"],
)
def test_bwd_wrapper_rejects_bad_shapes(states_shape, dy_shape):
    shapes = ((1, 2, 4, 2, 3), (1, 2, 4, 2), (1, 2, 4, 2), (1, 2, 4, 5), (1, 2, 4, 5))
    with pytest.raises(ValueError):
        kernel.ssd_chunk_scan_bwd(*(torch.zeros(s) for s in shapes),
                                  torch.zeros(states_shape), torch.zeros(dy_shape))
