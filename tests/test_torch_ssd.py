"""The port's SSD scan (repro_torch.kernels.ssd) against the JAX package.

On the CPU the port's wrappers run their plain versions; they are held
against the Pallas kernel in interpret mode (through ``repro.kernels.ssd``,
as tests/test_kernels.py runs it) and against the jnp references, on the
same numpy inputs.  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerance: 1e-5 times max(1, max|ref|) in float32 — y sums up to L*N and
L*P products per element, taken in another order.
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

TOL = 1e-5
# (b, s, h, p, n, chunk): the shapes of tests/test_kernels.py
SSD_SHAPES = [
    (1, 16, 1, 8, 8, 8),
    (2, 64, 4, 16, 32, 16),
    (1, 37, 2, 8, 16, 16),    # ragged seq vs chunk
    (3, 128, 8, 32, 64, 32),
    (2, 96, 3, 16, 16, 32),   # h not divisible by 4
]


def seq_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(b, s, h)).astype(np.float32)))
    a = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def chunk_inputs(b, nc, l_len, h, p, n, seed=0):
    x, dt, a, bm, cm = seq_inputs(b, nc * l_len, h, p, n, seed)
    dtc = dt.reshape(b, nc, l_len, h)
    cum = np.cumsum(dtc * a, axis=2).astype(np.float32)
    return (x.reshape(b, nc, l_len, h, p), dtc, cum,
            bm.reshape(b, nc, l_len, n), cm.reshape(b, nc, l_len, n))


def t_(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def close(got, want):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= TOL * max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_full_matches_pallas_and_naive_recurrence(b, s, h, p, n, chunk):
    x, dt, a, bm, cm = seq_inputs(b, s, h, p, n)
    got = ops.ssd_full(*t_(x, dt, a, bm, cm), chunk=chunk)
    close(got, jax_ops.ssd_full(x, dt, a, bm, cm, chunk=chunk))
    close(got, jax_ref.ssd_ref(x, dt, a, bm, cm))
    close(ref.ssd_ref(*t_(x, dt, a, bm, cm)), jax_ref.ssd_ref(x, dt, a, bm, cm))


@pytest.mark.parametrize(
    "b,nc,l_len,h,p,n", [(1, 2, 8, 1, 8, 8), (2, 4, 16, 3, 16, 32), (2, 3, 16, 4, 32, 16)]
)
def test_chunk_scan_and_entry_states_match_pallas(b, nc, l_len, h, p, n):
    args = chunk_inputs(b, nc, l_len, h, p, n, seed=1)
    y, states = kernel.ssd_chunk_scan(*t_(*args), return_states=True)
    h_tile = jax_ops._pick_h_tile(h)
    y_ref, states_ref = jax_kernel.ssd_chunk_scan(
        *args, h_tile=h_tile, interpret=True, return_states=True
    )
    close(y, y_ref)
    close(states, states_ref)
    close(states, jax_ref.ssd_chunk_states_ref(*args))
    close(kernel.ssd_chunk_scan(*t_(*args)), jax_ref.ssd_chunk_scan_ref(*args))
    close(ops.ssd_chunk_scan(*t_(*args)), y_ref)
    assert states.dtype == torch.float32 and tuple(states.shape) == (b, nc, h, p, n)
    assert float(states[:, 0].abs().max()) == 0.0


def test_cpu_autograd_through_the_plain_version_matches_jax_grads():
    b, s, h, p, n, chunk = 1, 24, 2, 8, 8, 8
    x, dt, a, bm, cm = seq_inputs(b, s, h, p, n, seed=2)
    cot = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    ref_grads = jax.grad(
        lambda *args: jnp.sum(jax_ops.ssd_full(*args, chunk=chunk) * cot), argnums=(0, 1, 3, 4)
    )(x, dt, a, bm, cm)
    leaves = t_(x, dt, a, bm, cm)
    for i in (0, 1, 3, 4):
        leaves[i].requires_grad_(True)
    y = ops.ssd_full(*leaves, chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [leaves[i] for i in (0, 1, 3, 4)])
    for g, r in zip(got, ref_grads):
        close(g, r)


def test_strong_decay_localizes():
    """With very fast decay the output reduces to the diagonal term dt * C.B * x."""
    b, s, h, p, n = 1, 12, 2, 4, 8
    x, _, _, bm, cm = seq_inputs(b, s, h, p, n, seed=4)
    dt = np.ones((b, s, h), np.float32)
    a = np.full((h,), -50.0, np.float32)
    out = ops.ssd_full(*t_(x, dt, a, bm, cm), chunk=4)
    diag = np.einsum("bsn,bsn->bs", cm, bm)[:, :, None, None] * x
    np.testing.assert_allclose(out.numpy(), diag, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize(
    "shapes",
    [
        ((1, 2, 4, 2, 3), (1, 2, 4, 3), (1, 2, 4, 3), (1, 2, 4, 5), (1, 2, 4, 5)),  # dt heads
        ((1, 2, 4, 2, 3), (1, 2, 4, 2), (1, 2, 4, 2), (1, 2, 4, 5), (1, 2, 4, 6)),  # B vs C
        ((1, 2, 4, 2, 3), (1, 2, 4, 2), (1, 2, 3, 2), (1, 2, 4, 5), (1, 2, 4, 5)),  # cum length
        ((2, 4, 2, 3), (2, 4, 2), (2, 4, 2), (2, 4, 5), (2, 4, 5)),                # unchunked
    ],
)
def test_wrapper_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError):
        kernel.ssd_chunk_scan(*(torch.zeros(s) for s in shapes))
