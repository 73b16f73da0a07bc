"""The stages of the port's SSD kernels (repro_torch.kernels.ssd.ref) against
the JAX package, and the 3xTF32 products they run on the tensor cores.

The CUDA kernels compute the chunk scan and its backward in stages: C B^T
once per chunk, the chunk-local states, the state carry, y per chunk; and
backward the carry of dy, its reverse pass, the per-head terms, the
head-summed dG and dB, dC.  Each stage has a plain version in ref.py; here
their compositions are held against the Pallas kernels in interpret mode
(called directly, as tests/test_torch_ssd_bwd.py calls them) on the same
numpy inputs, including NC=3 and chunk lengths that are not a multiple of
the kernels' 64-row tiles.  On CPU tensors the stage wrappers of kernel.py
return the plain stages.  The card holds each stage kernel against its plain
stage in tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerance: 1e-5 times max(1, max|ref|) in float32, as in
tests/test_torch_ssd_bwd.py: sums of up to L*N and L*P products (and, for
dB and dC, over the heads) taken in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels.ssd import kernel as jax_kernel  # noqa: E402
from repro.kernels.ssd import ref as jax_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel, ref  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = [  # B, NC, L, H, P, N
    (2, 1, 16, 4, 8, 16),
    (2, 3, 16, 2, 8, 16),   # the carry across three chunks
    (1, 3, 12, 3, 5, 9),    # ragged: L, P, N not multiples of the tiles
]


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


def scaled_err(got, want) -> float:
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("shape", SHAPES, ids=["nc1", "nc3", "ragged"])
def test_forward_stages_compose_to_the_pallas_scan(shape):
    args, _ = chunk_inputs(*shape, seed=sum(shape))
    want_y, want_states = jax_kernel.ssd_chunk_scan(*args, return_states=True, interpret=True)
    y, states = ref.ssd_chunk_scan_stages_ref(*t_(*args))
    assert scaled_err(y, want_y) <= TOL
    assert scaled_err(states, want_states) <= TOL


@pytest.mark.parametrize("shape", SHAPES, ids=["nc1", "nc3", "ragged"])
def test_backward_stages_compose_to_the_pallas_backward(shape):
    args, dy = chunk_inputs(*shape, seed=sum(shape) + 1)
    states = np.asarray(jax_ref.ssd_chunk_states_ref(*args))
    want = jax_kernel.ssd_chunk_scan_bwd(*args, states, dy, interpret=True)
    got = ref.ssd_chunk_scan_bwd_stages_ref(*t_(*args, states, dy))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert scaled_err(g, w) <= TOL


def test_stage_wrappers_take_the_plain_stages_on_cpu():
    args, dy = chunk_inputs(*SHAPES[1], seed=3)
    xc, dtc, cum, bc, cc = t_(*args)
    dy_t = torch.from_numpy(dy)
    states = ref.ssd_chunk_states_ref(xc, dtc, cum, bc, cc)
    g = ref.chunk_cb_ref(bc, cc)
    carry = ref.chunk_carry_ref(dy_t, cum, cc)
    ds = ref.state_pass_ref(carry, cum, reverse=True)
    dg = ref.bwd_dg_ref(xc, dtc, cum, dy_t)
    pairs = [
        (kernel.stage_cb(bc, cc), g),
        (kernel.stage_local(xc, dtc, cum, bc), ref.chunk_local_ref(xc, dtc, cum, bc)),
        (kernel.stage_pass(ref.chunk_local_ref(xc, dtc, cum, bc), cum), states),
        (kernel.stage_y(xc, dtc, cum, cc, g, states), ref.ssd_chunk_scan_ref(xc, dtc, cum, bc, cc)),
        (kernel.stage_carry(dy_t, cum, cc), carry),
        (kernel.stage_pass(carry, cum, reverse=True), ds),
        (kernel.stage_dg(xc, dtc, cum, dy_t), dg),
    ]
    head = kernel.stage_head(xc, dtc, cum, bc, cc, states, ds, g, dy_t)
    dbc = kernel.stage_dbc(xc, dtc, cum, bc, cc, states, ds, dg, dy_t)
    full = ref.ssd_chunk_scan_bwd_ref(xc, dtc, cum, bc, cc, states, dy_t)
    pairs += list(zip(head, full[:3])) + list(zip(dbc, full[3:]))
    for got, want in pairs:
        assert scaled_err(got, want) <= TOL


# ---------------------------------------------------------------------------
# 3xTF32: what the tensor cores compute, emulated in float32
# ---------------------------------------------------------------------------


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round to nearest (ties away from zero) at 10 mantissa bits, as
    cvt.rna.tf32.f32 does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: operands rounded, products exact, sums in float32."""
    return tf32(a) @ tf32(b)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hi = tf32(a), lo = tf32(a - hi); lo hi + hi lo + hi hi, small terms first."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def chunk_y(mm, x, dt, cum, bm, cm, state):
    """y of one chunk and H heads, every tile product through ``mm``:
    G = C B^T, y = (G decay dt_m) x + e_l C S^T."""
    l_len = x.shape[0]
    causal = torch.ones(l_len, l_len, dtype=torch.bool).tril()
    g = mm(cm, bm.T)
    heads = []
    for h in range(x.shape[1]):
        diff = cum[:, h, None] - cum[None, :, h]
        w = g * torch.exp(torch.where(causal, diff, -1e30)) * dt[None, :, h]
        heads.append(mm(w, x[:, h]) + torch.exp(cum[:, h, None]) * mm(cm, state[h].T))
    return torch.stack(heads, dim=1)


def test_3xtf32_products_keep_float32_accuracy():
    """One chunk of L=256, P=64, N=128, H=2 with a carried state: 3xTF32 is
    within 1e-5 (scaled) of float32; one TF32 product per product is not
    within the card's 1e-4 tolerance."""
    rng = np.random.default_rng(0)
    l_len, h, p, n = 256, 2, 64, 128
    dt = np.log1p(np.exp(rng.normal(size=(l_len, h))))
    a = -np.exp(rng.normal(size=(h,)) * 0.5)
    arrays = (rng.normal(size=(l_len, h, p)), dt, np.cumsum(dt * a, axis=0),
              rng.normal(size=(l_len, n)), rng.normal(size=(l_len, n)),
              rng.normal(size=(h, p, n)))
    inputs = [torch.tensor(v, dtype=torch.float32) for v in arrays]
    f32 = chunk_y(torch.matmul, *inputs)
    f64 = chunk_y(torch.matmul, *(v.double() for v in inputs))
    three = scaled_err(chunk_y(mm_3xtf32, *inputs), f32)
    one = scaled_err(chunk_y(mm_tf32, *inputs), f32)
    assert three <= 1e-5
    assert one > 1e-4
    # 3xTF32 is as close to a float64 reference as float32 itself is.
    assert scaled_err(chunk_y(mm_3xtf32, *inputs), f64.float()) <= scaled_err(f32, f64.float()) + 1e-5


def test_tf32_rounding_is_to_nearest_at_ten_mantissa_bits():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 4, 1.0 + one_ulp * 3 / 4, 1.0 + one_ulp / 2,
                      -(1.0 + one_ulp * 3 / 4), 3.0e-3])
    got = tf32(x)
    assert got[:5].tolist() == [1.0, 1.0, 1.0 + one_ulp, 1.0 + one_ulp, -(1.0 + one_ulp)]
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    # hi + lo carries the value to within float32's own rounding of it.
    v = torch.tensor(np.random.default_rng(1).normal(size=1000), dtype=torch.float32)
    hi = tf32(v)
    assert float(((hi + tf32(v - hi)) - v).abs().max()) <= float(v.abs().max()) * 2.0 ** -21
