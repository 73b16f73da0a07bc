"""The CUDA kernels (gru_scan, ssd_chunk_scan and its backward) on the card
against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: gru_scan forward and dx_gates 1e-5; dW_hh / db_hh 1e-4 times
max(1, max|ref|), as sums over B*T terms taken in another order; in
bfloat16 and float16, one unit in the last place of the dtype times
max(1, |ref|), the kernels and the plain versions both computing in
float32 and rounding once; the
backward's two stage kernels against their plain twins the same;
ssd_chunk_scan and ssd_chunk_scan_bwd, and each of their stages against its
plain stage in ref.py, 1e-4 times max(1, max|ref|), as sums over up to L*N
and L*P products (and, for dB and dC, over the heads) taken in another
order, on the tensor cores in 3xTF32; in bfloat16 and float16 one unit in
the last place, or as close to the float64 answer as the float32 plain
version (``near``).

The cohort engine's batched step: a client's loss and gradients do not
depend on how many other clients share a step of 2 to 16, bit for bit; in
a step of up to 128 of the whole federation's 189 they lie within a few
units in the last place of the 189-wide step's.  So the width ladder's
round, and a chunked round, lie within rounding of the round at one full
width, not always on its bits.
Resident staging (batches gathered on the card through an index plan)
trains to rebuild staging's bits, chunks of one client included.

DP-SGD: the per-example step (C·B clients of batch 1 on the kernels'
client axis) on the card against the CPU (noise 0, dropout 0; 1e-5), and
the two engines' DP rounds on the card with noise and dropout (1e-5).

The async runtime: ``fedbuff`` at a full buffer with constant latency
(one-client tasks) against a synchronous FedAvg round on the card, both
engines (losses 1e-5, params 1e-4).

The control plane: a small sync and a small async job preempted and
resumed on the card give the uninterrupted run dir (``diff_runs`` empty).

Captured steps (``repro_torch/capture.py``): the cohort step captured as
CUDA graphs (one a width) and replayed gives the eager step's bits (under
``disable_capture()``) at C = 1, 4 and 35, with and without DP, on steps
where only some clients are valid, and over the paper's whole federation
(189 hospitals, fedavg-ac's shape): params, losses, every generator's
offset, the launches; so do the local and central steps; the wide GRU
kernels capture in global mode.  The ladder's round of fedavg-ac's shape
lies within ``LADDER_PARAM_TOL`` and ``LADDER_LOSS_TOL`` of the same round
run at the whole federation's width on every step.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.accuracy import ulp_err, within_one_ulp  # noqa: E402
from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ops import GRUScan  # noqa: E402
from repro_torch.kernels.gru_scan.ref import (  # noqa: E402
    gru_bwd_dw_ref,
    gru_bwd_recur_ref,
    gru_scan_bwd_ref,
    gru_scan_ref,
)
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_chunk_scan_bwd_ref,
    ssd_chunk_scan_ref,
    ssd_chunk_states_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(device, b, t, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(*lead, b, t, 3 * n)),
        rng.normal(size=(*lead, n, 3 * n)) * 0.3,
        rng.normal(size=(*lead, 3 * n)) * 0.1,
        rng.normal(size=(*lead, b, t, n)),
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def max_err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize(
    "lead,b,t,n",
    [((), 128, 24, 32), ((), 100, 24, 32), ((3,), 50, 24, 32), ((), 64, 24, 8),
     ((), 64, 24, 64), ((), 37, 5, 2), ((35,), 128, 24, 32), ((), 5, 1, 4), ((), 37, 5, 33),
     ((4480,), 1, 24, 32)],  # DP's per-example shape at arc: 35 clients x 128 examples
)
def test_kernels_match_plain_versions(cuda, lead, b, t, n):
    xg, w, bias, dy = inputs(cuda, b, t, n, lead=lead)
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    h = kernel.gru_scan(xg, w, bias)
    h_again = kernel.gru_scan(xg, w, bias)
    grads = kernel.gru_scan_bwd(xg, w, bias, h, dy)
    again = kernel.gru_scan_bwd(xg, w, bias, h, dy)
    torch.cuda.synchronize()
    assert (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches) == (before[0] + 2, before[1] + 2)
    assert max_err(h, gru_scan_ref(xg, w, bias)) <= 1e-5
    assert torch.equal(h, h_again)
    ref = gru_scan_bwd_ref(xg, w, bias, h, dy)
    assert max_err(grads[0], ref[0]) <= 1e-5
    for g, r in zip(grads[1:], ref[1:]):
        assert max_err(g, r) <= 1e-4 * max(1.0, float(r.abs().max()))
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


@pytest.mark.parametrize(
    "lead,b,t,n",
    [((), 128, 24, 32), ((35,), 128, 24, 32), ((3,), 50, 24, 32), ((), 64, 24, 8),
     ((), 64, 24, 64), ((), 37, 5, 2), ((), 5, 1, 4)],
)
def test_backward_stages_match_plain_twins(cuda, lead, b, t, n):
    xg, w, bias, dy = inputs(cuda, b, t, n, seed=2, lead=lead)
    h = gru_scan_ref(xg, w, bias)
    before = kernel.gru_scan_bwd.launches
    dx, dgn = kernel.stage_recur(xg, w, bias, h, dy)
    again = kernel.stage_recur(xg, w, bias, h, dy)
    torch.cuda.synchronize()
    dx_r, dgn_r = gru_bwd_recur_ref(xg, w, bias, h, dy)
    assert max_err(dx, dx_r) <= 1e-5 and max_err(dgn, dgn_r) <= 1e-5
    assert torch.equal(dx, again[0]) and torch.equal(dgn, again[1])
    # The dW/db stage on the plain recurrence's outputs.
    dw, db = kernel.stage_dw(h, dx_r, dgn_r)
    dw2, db2 = kernel.stage_dw(h, dx_r, dgn_r)
    torch.cuda.synchronize()
    for g, r in zip((dw, db), gru_bwd_dw_ref(h, dx_r, dgn_r)):
        assert g.shape == r.shape
        assert max_err(g, r) <= 1e-4 * max(1.0, float(r.abs().max()))
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert kernel.gru_scan_bwd.launches == before


def test_autograd_runs_both_kernels(cuda):
    xg, w, bias, dy = inputs(cuda, 16, 24, 32, seed=1)
    leaves = [x.requires_grad_(True) for x in (xg, w, bias)]
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    h = GRUScan.apply(*leaves)
    grads = torch.autograd.grad(h, leaves, dy)
    assert (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = gru_scan_bwd_ref(xg.detach(), w.detach(), bias.detach(), h.detach(), dy)
    assert max_err(grads[0], ref[0]) <= 1e-5


@pytest.mark.parametrize("dtype,lead,b,t,n", [
    (torch.float32, (), 16, 6, 65), (torch.float32, (3,), 20, 5, 128),
    (torch.float32, (), 2, 3, 1024), (torch.float32, (2,), 1, 4, 96),
    (torch.float32, (), 2, 3, 7000),   # the backward's row tile in device scratch
    (torch.bfloat16, (), 16, 6, 32), (torch.bfloat16, (2,), 9, 5, 128),
    (torch.float16, (), 16, 6, 32), (torch.float16, (2,), 9, 5, 128),
    (torch.float32, (70000,), 1, 4, 4), (torch.bfloat16, (70000,), 1, 4, 4),
])
def test_every_hidden_size_dtype_and_client_count(cuda, dtype, lead, b, t, n):
    """The kernels take any N (the wide ones above 64), bfloat16 and float16,
    and more than 65,535 clients, against the plain versions: float32 as
    above, below it one unit in the last place of the dtype times max(1,
    |ref|); two runs the same bits; GRUScan's gradients in the inputs' dtype.
    W_hh is drawn at std min(0.3, 1/sqrt(N)): at 0.3 the recurrence is
    chaotic above N ~ 64, and float32 rounding alone, the plain version on
    the card against itself on the CPU, grows past 1e-5 in a few steps."""
    xg, w, bias, dy = inputs(cuda, b, t, n, seed=n, lead=lead)
    w = w * min(1.0, 1.0 / (0.3 * n ** 0.5))
    xg, w, bias, dy = (a.to(dtype) for a in (xg, w, bias, dy))
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    h, h2 = kernel.gru_scan(xg, w, bias), kernel.gru_scan(xg, w, bias)
    got, again = (kernel.gru_scan_bwd(xg, w, bias, h, dy) for _ in range(2))
    torch.cuda.synchronize()
    assert (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches) == (before[0] + 2,
                                                                        before[1] + 2)
    ref = (gru_scan_ref(xg, w, bias), *gru_scan_bwd_ref(xg, w, bias, h, dy))
    for g, r in zip((h, *got), ref):
        assert g.dtype == r.dtype == dtype and g.shape == r.shape
    if dtype == torch.float32:
        assert max_err(h, ref[0]) <= 1e-5 and max_err(got[0], ref[1]) <= 1e-5
        for g, r in zip(got[1:], ref[2:]):
            assert max_err(g, r) <= 1e-4 * max(1.0, float(r.abs().max()))
    else:
        assert all(ulp_err(g, r) <= 1.0 for g, r in zip((h, *got), ref))
    assert torch.equal(h, h2) and all(torch.equal(a, b_) for a, b_ in zip(got, again))
    leaves = [x.clone().requires_grad_(True) for x in (xg, w, bias)]
    grads = torch.autograd.grad(GRUScan.apply(*leaves), leaves, dy)
    assert [g.dtype for g in grads] == [dtype] * 3


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    xg, w, bias, _ = inputs(cuda, 4, 3, 2)
    with pytest.raises(TypeError):
        kernel.gru_scan(xg.double(), w.double(), bias.double())
    with pytest.raises(ValueError):
        kernel.gru_scan(xg.transpose(0, 1), w, bias)
    # Above N = 64 the wide kernels run: no hidden size is refused.
    wide = inputs(cuda, 2, 2, 65)
    assert max_err(kernel.gru_scan(*wide[:3]), gru_scan_ref(*wide[:3])) <= 1e-5
    with pytest.raises(ValueError):
        kernel.gru_scan(xg, w.cpu(), bias)


def ssd_inputs(device, b, nc, l_len, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, nc, l_len, h))))
    a = -np.exp(rng.normal(size=(h,)) * 0.5)
    arrays = (
        rng.normal(size=(b, nc, l_len, h, p)),
        dt,
        np.cumsum(dt * a, axis=2),
        rng.normal(size=(b, nc, l_len, n)),
        rng.normal(size=(b, nc, l_len, n)),
    )
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in arrays]


def scaled_err(got, ref):
    return max_err(got, ref) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize(
    "b,nc,l_len,h,p,n",
    [(2, 2, 256, 24, 64, 128), (1, 1, 256, 24, 64, 128), (2, 4, 16, 16, 32, 16),
     (1, 3, 100, 3, 48, 33), (2, 2, 64, 5, 1, 1)],
)
def test_ssd_kernel_matches_plain_versions(cuda, b, nc, l_len, h, p, n):
    args = ssd_inputs(cuda, b, nc, l_len, h, p, n)
    before = ssd_kernel.ssd_chunk_scan.launches
    y, states = ssd_kernel.ssd_chunk_scan(*args, return_states=True)
    again = ssd_kernel.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_scan.launches == before + 2
    assert scaled_err(y, ssd_chunk_scan_ref(*args)) <= 1e-4
    assert scaled_err(states, ssd_chunk_states_ref(*args)) <= 1e-4
    assert torch.equal(y, again)


def twice(fn, *args):
    """fn(*args) twice, each result a tuple of tensors."""
    def run():
        out = fn(*args)
        return out if isinstance(out, tuple) else (out,)
    return run(), run()


def hold(fn, plain, args, mask=None):
    """A stage kernel against its plain stage, and two runs bit for bit."""
    got, again = twice(fn, *args)
    torch.cuda.synchronize()
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, a, r in zip(got, again, want):
        if mask is not None:
            g, a, r = mask(g), mask(a), mask(r)
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        assert scaled_err(g, r) <= 1e-4
        assert torch.equal(g, a)


@pytest.mark.parametrize(
    "b,nc,l_len,h,p,n",
    [(2, 2, 256, 24, 64, 128), (1, 1, 256, 24, 64, 128), (2, 4, 16, 16, 32, 16),
     (1, 3, 100, 3, 48, 33), (2, 2, 64, 5, 1, 1)],
)
def test_ssd_forward_stages_match_plain_stages(cuda, b, nc, l_len, h, p, n):
    xc, dtc, cum, bc, cc = ssd_inputs(cuda, b, nc, l_len, h, p, n, seed=3)
    hold(ssd_kernel.stage_cb, ssd_ref.chunk_cb_ref, (bc, cc), mask=torch.tril)
    hold(ssd_kernel.stage_local, ssd_ref.chunk_local_ref, (xc, dtc, cum, bc))
    local = ssd_ref.chunk_local_ref(xc, dtc, cum, bc)
    hold(ssd_kernel.stage_pass, ssd_ref.state_pass_ref, (local, cum))
    g, states = ssd_ref.chunk_cb_ref(bc, cc), ssd_chunk_states_ref(xc, dtc, cum, bc, cc)
    hold(ssd_kernel.stage_y, ssd_ref.chunk_y_ref, (xc, dtc, cum, cc, g, states))


@pytest.mark.parametrize(
    "b,nc,l_len,h,p,n",
    [(1, 3, 256, 3, 64, 128), (1, 1, 256, 24, 64, 128), (2, 4, 16, 16, 32, 16),
     (1, 3, 100, 3, 48, 33), (2, 2, 64, 5, 1, 1), (1, 3, 8, 3, 8, 16)],
)
def test_ssd_backward_stages_match_plain_stages(cuda, b, nc, l_len, h, p, n):
    xc, dtc, cum, bc, cc, states, dy = ssd_bwd_inputs(cuda, b, nc, l_len, h, p, n, seed=4)
    hold(ssd_kernel.stage_carry, ssd_ref.chunk_carry_ref, (dy, cum, cc))
    carry = ssd_ref.chunk_carry_ref(dy, cum, cc)
    hold(lambda f, c: ssd_kernel.stage_pass(f, c, reverse=True),
         lambda f, c: ssd_ref.state_pass_ref(f, c, reverse=True), (carry, cum))
    ds = ssd_ref.state_pass_ref(carry, cum, reverse=True)
    g = ssd_ref.chunk_cb_ref(bc, cc)
    hold(ssd_kernel.stage_head, ssd_ref.bwd_head_ref, (xc, dtc, cum, bc, cc, states, ds, g, dy))
    hold(ssd_kernel.stage_dg, ssd_ref.bwd_dg_ref, (xc, dtc, cum, dy))
    dg = ssd_ref.bwd_dg_ref(xc, dtc, cum, dy)
    hold(ssd_kernel.stage_dbc, ssd_ref.bwd_dbc_ref, (xc, dtc, cum, bc, cc, states, ds, dg, dy))


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """float64 (alone or mixed in), integers, non-contiguous input and mixed
    devices; no chunk, head or state size up to the longest chunk."""
    args = ssd_inputs(cuda, 1, 1, 8, 2, 4, 4)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_chunk_scan(*(a.double() for a in args))
    with pytest.raises(TypeError):
        ssd_kernel.ssd_chunk_scan(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        ssd_kernel.ssd_chunk_scan(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan(args[0].transpose(3, 4).contiguous().transpose(3, 4), *args[1:])
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError):
        # One row past the longest chunk the kernels' shared memory holds.
        ssd_kernel.ssd_chunk_scan(*ssd_inputs(cuda, 1, 1, 16_321, 1, 1, 1))
    for shape in ((1, 1, 257, 1, 4, 4), (1, 1, 8, 1, 65, 4), (1, 1, 8, 1, 4, 129)):
        xs = ssd_inputs(cuda, *shape)
        assert scaled_err(ssd_kernel.ssd_chunk_scan(*xs), ssd_chunk_scan_ref(*xs)) <= 1e-4
    leaves = [a.requires_grad_(True) for a in args]
    y = ssd_ops.ssd_chunk_scan(*leaves)  # the backward kernel is ported: no NotImplementedError
    assert y.requires_grad and y.grad_fn is not None


def test_mamba2_prefill_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.zoo import Model
    from repro_torch.tree import tree_map

    model = Model(get_config("mamba2-130m").reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 37)))
    step = make_prefill_step(model)
    want = step(params, {"tokens": toks})
    on_card = tree_map(lambda t: t.to(cuda), params)
    before = ssd_kernel.ssd_chunk_scan.launches
    got = step(on_card, {"tokens": toks.to(cuda)})
    assert ssd_kernel.ssd_chunk_scan.launches == before + model.cfg.num_layers
    assert scaled_err(got.cpu(), want) <= 1e-4


def ssd_bwd_inputs(device, b, nc, l_len, h, p, n, seed=0):
    args = ssd_inputs(device, b, nc, l_len, h, p, n, seed)
    states = ssd_chunk_states_ref(*args)
    dy = torch.tensor(np.random.default_rng(seed + 1).normal(size=tuple(args[0].shape)),
                      dtype=torch.float32, device=device)
    return [*args, states, dy]


@pytest.mark.parametrize(
    "b,nc,l_len,h,p,n",
    [(1, 3, 256, 3, 64, 128), (1, 1, 256, 24, 64, 128), (2, 4, 16, 16, 32, 16),
     (1, 3, 100, 3, 48, 33), (2, 2, 64, 5, 1, 1), (1, 3, 8, 3, 8, 16)],
)
def test_ssd_bwd_kernel_matches_plain_version(cuda, b, nc, l_len, h, p, n):
    args = ssd_bwd_inputs(cuda, b, nc, l_len, h, p, n)
    before = ssd_kernel.ssd_chunk_scan_bwd.launches
    grads = ssd_kernel.ssd_chunk_scan_bwd(*args)
    again = ssd_kernel.ssd_chunk_scan_bwd(*args)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_scan_bwd.launches == before + 2
    for g, r, a in zip(grads, ssd_chunk_scan_bwd_ref(*args), again):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        assert scaled_err(g, r) <= 1e-4
        assert torch.equal(g, a)


def test_ssd_bwd_strong_decay_stays_finite(cuda):
    """cum falls by 50 a step: an unmasked exp(cum_l - cum_m) would overflow."""
    args = ssd_bwd_inputs(cuda, 1, 2, 64, 2, 8, 16)
    args[2] = torch.cumsum(torch.full_like(args[1], -50.0), dim=2)
    args[5] = ssd_chunk_states_ref(*args[:5])
    grads = ssd_kernel.ssd_chunk_scan_bwd(*args)
    for g, r in zip(grads, ssd_chunk_scan_bwd_ref(*args)):
        assert bool(torch.isfinite(g).all())
        assert scaled_err(g, r) <= 1e-4


def test_ssd_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """float64, states other than float32, non-contiguous input, a wrong
    shape and mixed devices; no chunk, head or state size."""
    args = ssd_bwd_inputs(cuda, 1, 2, 8, 2, 4, 4)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_chunk_scan_bwd(*(a.double() for a in args))
    with pytest.raises(TypeError):
        ssd_kernel.ssd_chunk_scan_bwd(*args[:5], args[5].bfloat16(), args[6])
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan_bwd(*args[:6], args[6].transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan_bwd(*args[:5], args[5][:, :1], args[6])
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan_bwd(*args[:6], args[6].cpu())
    for shape in ((1, 1, 257, 1, 4, 4), (1, 1, 8, 1, 65, 4), (1, 1, 8, 1, 4, 129)):
        xs = ssd_bwd_inputs(cuda, *shape)
        for g, r in zip(ssd_kernel.ssd_chunk_scan_bwd(*xs), ssd_chunk_scan_bwd_ref(*xs)):
            assert scaled_err(g, r) <= 1e-4


def near(got, plain, plain64) -> bool:
    """A kernel output against its plain version: float32 within 1e-4 times
    max(1, max|ref|); below it within one unit in the last place of the
    plain version computed in float64 (``within_one_ulp``)."""
    if got.dtype == torch.float32:
        return scaled_err(got, plain) <= 1e-4
    return within_one_ulp(got, plain64)


@pytest.mark.parametrize("dtype,b,nc,l_len,h,p,n", [
    (torch.bfloat16, 2, 2, 256, 24, 64, 128), (torch.float16, 2, 2, 256, 24, 64, 128),
    (torch.bfloat16, 1, 3, 100, 3, 48, 33), (torch.float16, 1, 3, 100, 3, 20, 36),
    (torch.float32, 1, 2, 512, 2, 128, 256), (torch.bfloat16, 1, 2, 512, 2, 128, 256),
    (torch.float32, 1, 2, 320, 3, 72, 200), (torch.float16, 1, 2, 80, 2, 72, 136),
    (torch.float32, 1, 70000, 8, 2, 4, 4), (torch.bfloat16, 70000, 1, 8, 2, 4, 4),
    (torch.float32, 131073, 1, 4, 1, 2, 2),
])
def test_ssd_every_dtype_size_and_row_count(cuda, dtype, b, nc, l_len, h, p, n):
    """bfloat16 and float16, L / P / N above 256 / 64 / 128 and more than
    65,535 (batch, chunk) rows, against the plain versions (the stage
    compositions above 65,535 chunks: one pass over them), as ``near``
    says; the entry states within 1e-4; each stage the same; two runs the
    same bits; one launch a call; SSDChunkScan's gradients in the inputs'
    dtype."""
    xs = [a.to(dtype) for a in ssd_inputs(cuda, b, nc, l_len, h, p, n)]
    dy = torch.tensor(np.random.default_rng(1).normal(size=tuple(xs[0].shape)),
                      dtype=torch.float32, device=cuda).to(dtype)
    before = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
    (y, states), (y2, states2) = (ssd_kernel.ssd_chunk_scan(*xs, return_states=True)
                                  for _ in range(2))
    got, again = (ssd_kernel.ssd_chunk_scan_bwd(*xs, states, dy) for _ in range(2))
    torch.cuda.synchronize()
    assert (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    if nc > 1000:
        fwd, bwd = ssd_ref.ssd_chunk_scan_stages_ref, ssd_ref.ssd_chunk_scan_bwd_stages_ref
        y_ref, s_ref = fwd(*xs)
    else:
        fwd, bwd = ssd_chunk_scan_ref, ssd_chunk_scan_bwd_ref
        y_ref, s_ref = fwd(*xs), ssd_chunk_states_ref(*xs)
    want = (y_ref, *bwd(*xs, states, dy))
    wide = [t.double() for t in (*xs, states, dy)]
    want64 = (want if dtype == torch.float32 else
              (fwd(*wide[:5])[0] if nc > 1000 else fwd(*wide[:5]), *bwd(*wide)))
    assert states.dtype == torch.float32 and scaled_err(states, s_ref) <= 1e-4
    for g, r, r64, a in zip((y, *got), want, want64, (xs[0], *xs)):
        assert g.dtype == a.dtype == dtype and g.shape == a.shape
        assert bool(torch.isfinite(g).all()) and near(g, r, r64)
    assert torch.equal(y, y2) and torch.equal(states, states2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    if b * nc <= 1000:
        g_, local = ssd_ref.chunk_cb_ref(xs[3], xs[4]), ssd_ref.chunk_local_ref(*xs[:4])
        ds = ssd_ref.state_pass_ref(ssd_ref.chunk_carry_ref(dy, xs[2], xs[4]), xs[2], reverse=True)
        dg = ssd_ref.bwd_dg_ref(xs[0], xs[1], xs[2], dy)
        for fn, plain, args, mask in (
            (ssd_kernel.stage_cb, ssd_ref.chunk_cb_ref, (xs[3], xs[4]), torch.tril),
            (ssd_kernel.stage_local, ssd_ref.chunk_local_ref, tuple(xs[:4]), None),
            (ssd_kernel.stage_pass, ssd_ref.state_pass_ref, (local, xs[2]), None),
            (ssd_kernel.stage_y, ssd_ref.chunk_y_ref,
             (xs[0], xs[1], xs[2], xs[4], g_, states), None),
            (ssd_kernel.stage_head, ssd_ref.bwd_head_ref, (*xs, states, ds, g_, dy), None),
            (ssd_kernel.stage_dg, ssd_ref.bwd_dg_ref, (xs[0], xs[1], xs[2], dy), torch.tril),
            (ssd_kernel.stage_dbc, ssd_ref.bwd_dbc_ref, (*xs, states, ds, dg, dy), None),
        ):
            tup = lambda t: (t,) if torch.is_tensor(t) else t
            outs, outs2, wants = (tup(f(*args)) for f in (fn, fn, plain))
            wants64 = tup(plain(*(t.double() for t in args)))
            for o, o2, w, w64 in zip(outs, outs2, wants, wants64):
                if mask is not None:
                    o, o2, w, w64 = mask(o), mask(o2), mask(w), mask(w64)
                assert near(o, w, w64) and torch.equal(o, o2)
        leaves = [a.clone().requires_grad_(True) for a in xs]
        grads = torch.autograd.grad(ssd_ops.SSDChunkScan.apply(*leaves), leaves, dy)
        assert [g.dtype for g in grads] == [dtype] * 5


def test_ssd_mixed_dtypes_take_each_inputs_dtype(cuda):
    """Inputs that mix float32, bfloat16 and float16 run the float32 kernels
    on exact float32 copies: y in x's dtype, each cotangent in its input's,
    the values the float32 call's rounded once."""
    xs = ssd_bwd_inputs(cuda, 1, 3, 100, 3, 48, 33)
    mixed = [xs[0].bfloat16(), xs[1], xs[2], xs[3].half(), xs[4].half()]
    exact = [t.float() for t in mixed]
    y, states = ssd_kernel.ssd_chunk_scan(*mixed, return_states=True)
    y32, states32 = ssd_kernel.ssd_chunk_scan(*exact, return_states=True)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
    assert torch.equal(states, states32)
    dy = xs[6].bfloat16()
    got = ssd_kernel.ssd_chunk_scan_bwd(*mixed, states, dy)
    want = ssd_kernel.ssd_chunk_scan_bwd(*exact, states, dy.float())
    for g, w, a in zip(got, want, mixed):
        assert g.dtype == a.dtype and torch.equal(g, w.to(a.dtype))


def test_ssd_autograd_on_the_card_runs_both_kernels(cuda):
    """ssd_full with a ragged S=300 at chunk 256: gradients of every input
    against the same graph on the CPU (plain forward and backward)."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 300, 3, 64, 128
    arrays = (rng.normal(size=(b, s, h, p)), np.log1p(np.exp(rng.normal(size=(b, s, h)))),
              -np.exp(rng.normal(size=(h,)) * 0.5) * 0.02, rng.normal(size=(b, s, n)),
              rng.normal(size=(b, s, n)))
    cot = torch.tensor(rng.normal(size=(b, s, h, p)), dtype=torch.float32)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True)
                  for a in arrays]
        before = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
        y = ssd_ops.ssd_full(*leaves, chunk=256)
        grads[str(dev)] = torch.autograd.grad((y * cot.to(dev)).sum(), leaves)
        after = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
        assert after == (before if dev == "cpu" else (before[0] + 1, before[1] + 1))
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert scaled_err(g.cpu(), r) <= 1e-4


def test_mamba2_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.zoo import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    model = Model(get_config("mamba2-130m").reduced(), remat=False, loss_chunk=16)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(0).integers(0, 512, (2, 38))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    opt = AdamW(1e-3)
    step = make_train_step(model, opt)
    on_card = tree_map(lambda t: t.to(cuda), params)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    before = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
    new_card, _, m_card = step(on_card, opt.init(on_card), card_batch)
    after = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
    layers = model.cfg.num_layers
    assert after == (before[0] + layers, before[1] + layers)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    grads = torch.autograd.grad(model.loss(params, batch)[0], leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    new_cpu, _, m_cpu = step(params, opt.init(params), batch)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-4 * max(1.0, float(m_cpu["loss"]))
    # Where |g| < 1e-6, AdamW's first step lr g / (|g| + eps) follows the sign
    # of rounding noise, so those entries are held to the swing of a sign flip.
    for a, r, g in zip(tree_leaves(new_card), tree_leaves(new_cpu), grads):
        gap = (a.cpu() - r).abs()
        settled = g.abs() >= 1e-6
        assert bool(torch.isfinite(gap).all())
        if bool(settled.any()):
            assert float(gap[settled].max()) <= 1e-4
        assert float(gap.max()) <= 2 * opt.learning_rate + 1e-4


def narrow_and_full_steps(cuda, c, full):
    """One batched GRU step (B = 128, T = 24, dropout) of the first ``c`` of
    ``full`` clients, and of all ``full``: each one's losses and gradients."""
    from repro_torch.models import gru
    from repro_torch.tree import tree_leaves, tree_map

    cfg = gru.GRUConfig()
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, cuda)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(full, 128, 24, 38)), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.uniform(0.5, 20, size=(full, 128)), dtype=torch.float32, device=cuda)
    mask = torch.ones(full, 128, device=cuda)
    stacked = tree_map(lambda p: torch.stack([p + 0.01 * i for i in range(full)]), params)
    loss_fn = gru.make_loss_fn(cfg)

    def step(k):
        p = tree_map(lambda q: q[:k].clone().requires_grad_(True), stacked)
        gens = [torch.Generator(device=cuda).manual_seed(i) for i in range(k)]
        loss = loss_fn(p, (x[:k], y[:k], mask[:k]), gens)
        return loss, torch.autograd.grad(loss.sum(), tree_leaves(p))

    return step(c), step(full)


@pytest.mark.parametrize("c", [2, 3, 4, 8])
def test_cohort_step_does_not_depend_on_the_chunk_size(cuda, c):
    (loss, grads), (loss_all, grads_all) = narrow_and_full_steps(cuda, c, 16)
    assert torch.equal(loss, loss_all[:c])
    assert all(torch.equal(g, a[:c]) for g, a in zip(grads, grads_all))


# How far a client's losses (units in the last place of each loss) and
# gradients (of each leaf's largest entry) in a narrow step may lie from the
# whole federation's step: an H100 read at most 0.65 and 2.57.
LOSS_ULPS, GRAD_ULPS = 2, 8


@pytest.mark.parametrize("c", [2, 4, 8, 16, 32, 64, 128])
def test_a_narrow_step_is_the_whole_federations_step_within_rounding(cuda, c):
    """The widths of the paper's whole federation (fedavg-ac) against its
    full 189-client step: each client's losses and gradients are the same
    sums in another order (the library's products and reductions pick their
    kernels by the batch count), so they agree to a few units in the last
    place, bit for bit at some widths; the cohort engine runs its eager and
    its captured step at the same widths for that reason."""
    (loss, grads), (loss_all, grads_all) = narrow_and_full_steps(cuda, c, 189)
    eps = torch.finfo(torch.float32).eps
    ref = loss_all[:c]
    assert float(((loss - ref).abs() / (ref.abs() * eps)).max()) <= LOSS_ULPS
    for g, a in zip(grads, grads_all):
        scale = float(a[:c].abs().max()) * eps
        assert float((g - a[:c]).abs().max()) <= GRAD_ULPS * scale


@pytest.mark.parametrize("chunk", [1, 3, None])
def test_resident_staging_is_rebuild_staging_on_the_card(cuda, chunk):
    """A chunk staged resident (the batch gathered on the card from the
    resident cohort, the plan copied on a side stream when there are several
    chunks) trains to the rebuilt chunk's bits, a 1-client chunk included."""
    from repro_torch.data.pipeline import ArrayDataset, ClientDataset
    from repro_torch.federated.cohort import CohortTrainer, client_generators
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves

    rng = np.random.default_rng(0)
    clients = []
    for i, n in enumerate(rng.integers(40, 300, 5)):
        x = rng.normal(size=(int(n), 24, 38)).astype(np.float32)
        y = rng.uniform(0.5, 20, size=int(n)).astype(np.float32)
        clients.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
    cfg = gru.GRUConfig(dropout=0.05)
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, cuda)
    out, stats = {}, {}
    for staging in ("rebuild", "resident"):
        trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), 128, 2, cohort_chunk=chunk,
                                staging=staging, device=cuda)
        gens = client_generators(np.random.default_rng([0, 2]), len(clients), cuda)
        out[staging] = trainer.train_cohort(params, clients, np.random.default_rng(0), gens)
        stats[staging] = trainer.last_round_stats
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out["rebuild"][0]),
                                                 tree_leaves(out["resident"][0])))
    assert np.array_equal(out["rebuild"][1], out["resident"][1])
    assert stats["resident"]["prefetch"] == (chunk is not None)
    assert stats["resident"]["bytes_staged"] * 100 < stats["rebuild"]["bytes_staged"]
    assert stats["resident"]["peak_device_bytes"] > stats["resident"]["bytes_resident"] > 0


def dp_clients(rng, sizes):
    from repro_torch.data.pipeline import ArrayDataset, ClientDataset

    clients = []
    for i, n in enumerate(sizes):
        x = rng.normal(size=(int(n), 24, 38)).astype(np.float32)
        y = rng.uniform(0.5, 20, size=int(n)).astype(np.float32)
        clients.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
    return clients


def test_dp_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import gru
    from repro_torch.privacy.dp import DPConfig, dp_value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = gru.GRUConfig(dropout=0.0)
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    c, b = 4, 128
    stacked = tree_map(lambda p: torch.stack([p + 0.01 * i for i in range(c)]), params)
    rng = np.random.default_rng(1)
    mask = np.ones((c, b), np.float32)
    mask[:, 100:] = 0.0
    batch = (torch.tensor(rng.normal(size=(c, b, 24, 38)), dtype=torch.float32),
             torch.tensor(rng.uniform(0.5, 20, size=(c, b)), dtype=torch.float32),
             torch.from_numpy(mask))
    step = dp_value_and_grad(gru.make_loss_fn(cfg), DPConfig(clip_norm=1.0, noise_multiplier=0.0))
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    loss, grads = step(tree_map(lambda q: q.to(cuda), stacked), tuple(t.to(cuda) for t in batch),
                       None)
    torch.cuda.synchronize()
    # two layers: one forward and one backward launch each, at C·B = 512
    launched = (kernel.gru_scan.launches - before[0], kernel.gru_scan_bwd.launches - before[1])
    assert launched == (2, 2)
    loss_cpu, grads_cpu = step(stacked, batch, None)
    assert max_err(loss.cpu(), loss_cpu) <= 1e-5
    for g, r in zip(tree_leaves(grads), tree_leaves(grads_cpu)):
        assert max_err(g.cpu(), r) <= 1e-5


def test_dp_engines_agree_on_the_card(cuda):
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.federated.cohort import CohortTrainer, client_generators
    from repro_torch.federated.fedavg import aggregate_stacked, stack_trees
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW
    from repro_torch.privacy.dp import DPConfig
    from repro_torch.tree import tree_leaves

    clients = dp_clients(np.random.default_rng(0), (40, 200, 130))
    cfg = gru.GRUConfig(dropout=0.05)
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, cuda)
    privacy = DPConfig(clip_norm=1.0, noise_multiplier=1.0)
    vec = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), 128, 2, dp=privacy, device=cuda)
    gens = client_generators(np.random.default_rng([0, 2]), len(clients), cuda)
    got, losses, _ = vec.train_cohort(params, clients, np.random.default_rng(0), gens)
    seq = LocalTrainer(gru.make_loss_fn(cfg), AdamW(), 128, 2, device=cuda, dp=privacy)
    rng = np.random.default_rng(0)
    gens = client_generators(np.random.default_rng([0, 2]), len(clients), cuda)
    outs = [seq.train_client(params, cl, rng, g) for cl, g in zip(clients, gens)]
    want = aggregate_stacked(stack_trees([o[0] for o in outs]),
                             np.asarray([o[2] for o in outs], np.float32))
    assert np.abs(losses - np.asarray([o[1] for o in outs])).max() <= 1e-5
    assert max(max_err(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))) <= 1e-5


@pytest.mark.parametrize("engine", ["vectorized", "sequential"])
def test_fedbuff_full_buffer_matches_sync_fedavg_on_the_card(cuda, engine):
    """The async parity gate on the card: ``fedbuff:K`` at K = all clients
    with constant latency trains one-client tasks against the flush's params
    and equals a synchronous FedAvg round (losses 1e-5, params 1e-4; a C=1
    task takes other last bits than the C=5 round), every staleness 0."""
    from repro_torch.federated.api import Federation, FederationConfig
    from repro_torch.federated.runtime import AsyncFederation, AsyncFederationConfig
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves

    clients = dp_clients(np.random.default_rng(2), (40, 200, 130, 77, 260))
    cfg = gru.GRUConfig(dropout=0.05)
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, cuda)
    base = dict(rounds=2, local_epochs=2, batch_size=128, seed=0, engine=engine)
    sync = Federation(FederationConfig(**base), clients, gru.make_loss_fn(cfg), AdamW(),
                      device=cuda).run(params)
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    asyn = AsyncFederation(
        AsyncFederationConfig(**base, aggregator=f"fedbuff:{len(clients)}", latency="constant"),
        clients, gru.make_loss_fn(cfg), AdamW(), device=cuda).run(params)
    assert kernel.gru_scan.launches > before[0] and kernel.gru_scan_bwd.launches > before[1]
    assert [r.staleness for r in asyn.history] == [0.0, 0.0]
    assert [r.participant_ids for r in asyn.history] == [r.participant_ids for r in sync.history]
    assert max(abs(a.mean_local_loss - s.mean_local_loss)
               for a, s in zip(asyn.history, sync.history)) <= 1e-5
    assert max(max_err(a, b) for a, b in zip(tree_leaves(asyn.params),
                                             tree_leaves(sync.params))) <= 1e-4


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_a_job_cut_and_resumed_on_the_card_is_the_uninterrupted_job(cuda, tmp_path, mode):
    """The control plane on the card: a small job (16 hospitals, GRU N=8)
    preempted after its first snapshot and resumed gives the uninterrupted
    run dir (``diff_runs`` empty: participants and virtual times exact,
    losses and final params within 1e-5), through both GRU kernels."""
    from repro_torch.launch.federation_service import (
        JobPreempted,
        diff_runs,
        resume_job,
        status_job,
        submit_job,
    )

    spec = {"name": f"card-{mode}", "mode": mode, "rounds": 3, "local_epochs": 1,
            "batch_size": 16, "seed": 1, "recruitment": "all",
            "data": {"scale": 0.01, "num_hospitals": 16, "split_mode": "stratified"},
            "model": {"hidden_dim": 8, "num_layers": 2}}
    if mode == "sync":
        spec["selection"] = "loss-weighted:6"
    else:
        spec.update(aggregator="fedbuff:4", latency="lognormal:0.6", dropout="bernoulli:0.1")
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    submit_job(spec, full, device=cuda)
    with pytest.raises(JobPreempted):
        submit_job(spec, cut, device=cuda, preempt_after=1)
    assert status_job(cut)["status"] == "preempted"
    assert resume_job(cut, device=cuda)["resumed_from"] == 1
    assert kernel.gru_scan.launches > before[0] and kernel.gru_scan_bwd.launches > before[1]
    assert diff_runs(cut, full) == []


def captured_and_eager_rounds(cuda, trainer_for, clients, rounds=2):
    """``rounds`` rounds of ``trainer_for()``'s ``train_cohort`` captured,
    then of another under ``disable_capture()``, from one init and seeds:
    for each, the params, every round's losses, the generators' offsets
    after each round, the GRU launches and the round stats."""
    from repro_torch.capture import disable_capture
    from repro_torch.federated.cohort import client_generators
    from repro_torch.models import gru

    out = {}
    for mode in ("captured", "eager"):
        with disable_capture() if mode == "eager" else contextlib.nullcontext():
            trainer = trainer_for()
            params = gru.init_gru(torch.Generator().manual_seed(0), gru.GRUConfig(), cuda)
            rng, gen_rng = np.random.default_rng(0), np.random.default_rng([0, 2])
            before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
            losses, offsets, stats = [], [], []
            for _ in range(rounds):
                gens = client_generators(gen_rng, len(clients), cuda)
                params, loss, _ = trainer.train_cohort(params, clients, rng, gens)
                losses.append(loss)
                offsets.append([g.get_offset() for g in gens])
                stats.append(dict(trainer.last_round_stats))
            launches = (kernel.gru_scan.launches - before[0],
                        kernel.gru_scan_bwd.launches - before[1])
            out[mode] = (params, losses, offsets, launches, stats)
    return out


@pytest.mark.parametrize("c", [1, 4, 35])
@pytest.mark.parametrize("dp", [False, True], ids=["no-dp", "dp"])
def test_captured_cohort_rounds_replay_the_eager_bits(cuda, c, dp):
    """The cohort step captured as CUDA graphs (one a width its steps use)
    and replayed gives the eager step's bits: params, losses, every
    generator's offset after each round (dropout 0.05, DP with noise), on
    steps where only some clients are valid; the launches and the slots
    are the eager ones, and round 2 captures nothing."""
    from repro_torch.federated.cohort import CohortTrainer, step_widths
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW
    from repro_torch.privacy.dp import DPConfig
    from repro_torch.tree import tree_leaves

    sizes = [1 + (37 * i) % 90 for i in range(c)]   # 1 to 6 batches of 16 a client
    clients = dp_clients(np.random.default_rng(c), sizes)

    def trainer_for():
        return CohortTrainer(gru.make_loss_fn(gru.GRUConfig(dropout=0.05)), AdamW(), 16, 2,
                             staging="resident", dp=DPConfig(1.0, 1.0) if dp else None,
                             device=cuda)

    out = captured_and_eager_rounds(cuda, trainer_for, clients)
    (p_c, l_c, o_c, n_c, s_c), (p_e, l_e, o_e, n_e, s_e) = out["captured"], out["eager"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_c), tree_leaves(p_e)))
    assert all(np.array_equal(a, b) for a, b in zip(l_c, l_e))
    assert o_c == o_e and all(o > 0 for o in o_c[0])   # every client drew
    assert n_c == n_e
    graphs = len(step_widths(sizes, 16))   # one a width the steps use
    assert [s["captures"] for s in s_c] == [graphs, 0]
    assert [s["captures"] for s in s_e] == [0, 0]
    assert all(s["replays"] == s["cohort_steps"] for s in s_c)
    assert [s["cohort_slot_steps"] for s in s_c] == [s["cohort_slot_steps"] for s in s_e]
    assert s_c[0]["graph_pool_bytes"] > 0 and s_c[0]["capture_seconds"] > 0


def whole_federation(seed):
    """The 189 hospitals of the synthetic cohort at seed 0 (their sizes, as
    the benchmark freezes them; values from ``seed``)."""
    import json
    from pathlib import Path

    structure = Path(__file__).parents[1] / "bench" / "configs" / "gru-eicu" / "cohort.json"
    sizes = [h["n_train"] for h in json.loads(structure.read_text())["hospitals"]]
    return dp_clients(np.random.default_rng(seed), sizes)


def whole_federation_trainer(cuda):
    """fedavg-ac's trainer: batch 128, 4 local epochs, resident staging,
    dropout 0.05, AdamW 5e-3 / 5e-3."""
    from repro_torch.federated.cohort import CohortTrainer
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW

    return CohortTrainer(gru.make_loss_fn(gru.GRUConfig(dropout=0.05)),
                         AdamW(5e-3, weight_decay=5e-3), 128, 4, staging="resident",
                         device=cuda)


def test_the_whole_federations_captured_round_is_its_eager_round(cuda):
    """One round of fedavg-ac's shape (``whole_federation``).  Captured
    (seven graphs, one a width) it gives the ``disable_capture()`` round's
    bits: params, every client's loss and generator offset."""
    from repro_torch.tree import tree_leaves

    out = captured_and_eager_rounds(cuda, lambda: whole_federation_trainer(cuda),
                                    whole_federation(2147483659), rounds=1)
    (p_c, l_c, o_c, n_c, s_c), (p_e, l_e, o_e, n_e, s_e) = out["captured"], out["eager"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_c), tree_leaves(p_e)))
    assert np.array_equal(l_c[0], l_e[0]) and o_c == o_e and n_c == n_e
    assert (s_c[0]["captures"], s_c[0]["replays"], s_c[0]["cohort_steps"]) == (7, 264, 264)
    assert s_c[0]["cohort_slot_steps"] == s_e[0]["cohort_slot_steps"] == 2992


def ladder_and_full_width_gaps(cuda, seed):
    """One captured round of fedavg-ac's shape on the width ladder, and one
    with every step forced to the whole federation's width (the step before
    the ladder), from one init and seeds: the largest gap of a params leaf
    over that leaf's largest magnitude, the largest relative gap of a
    client's loss, whether every generator ends at the same offset, and
    each round's stats."""
    from repro_torch.federated import cohort
    from repro_torch.models import gru
    from repro_torch.tree import tree_leaves

    clients = whole_federation(seed)
    out = {}
    for ladder in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not ladder:
                mp.setattr(cohort, "step_width", lambda valid: len(valid))
            trainer = whole_federation_trainer(cuda)
            params = gru.init_gru(torch.Generator().manual_seed(0), gru.GRUConfig(), cuda)
            gens = cohort.client_generators(np.random.default_rng([0, 2]), len(clients), cuda)
            params, losses, _ = trainer.train_cohort(params, clients, np.random.default_rng(0),
                                                     gens)
            out[ladder] = (tree_leaves(params), np.asarray(losses, np.float64),
                           [g.get_offset() for g in gens], dict(trainer.last_round_stats))
    (p_l, l_l, o_l, s_l), (p_f, l_f, o_f, s_f) = out[True], out[False]
    param_gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(p_l, p_f))
    loss_gap = float(np.max(np.abs(l_l - l_f) / np.abs(l_f)))
    return param_gap, loss_gap, o_l == o_f, (s_l, s_f)


# How far the ladder's round of fedavg-ac's shape may lie from the round at
# the whole federation's width: its steps are the same sums, in another
# order at some widths (``test_a_narrow_step_is_the_whole_federations_step_
# within_rounding``), carried through up to 264 local steps.  An H100 read
# params 1.75e-7 to 6.41e-7 and losses 9.9e-8 to 1.11e-7 over six value
# seeds (1.96e-7 and 1.04e-7 at this test's).
LADDER_PARAM_TOL, LADDER_LOSS_TOL = 3e-6, 1e-6


def test_the_whole_federations_ladder_round_is_its_full_width_round(cuda):
    """The ladder's captured round against the same round with every step
    at the whole federation's width: params and every client's loss within
    rounding, every generator at the same offset (a client draws only on
    its own steps either way), 2,992 slots against 264 × 189."""
    param_gap, loss_gap, same_offsets, (ladder, full) = ladder_and_full_width_gaps(
        cuda, 2147483659)
    assert param_gap <= LADDER_PARAM_TOL and loss_gap <= LADDER_LOSS_TOL
    assert same_offsets
    assert (ladder["captures"], full["captures"]) == (7, 1)
    assert (ladder["cohort_slot_steps"], full["cohort_slot_steps"]) == (2992, 264 * 189)


def test_a_captured_trainer_is_freed_when_dropped(cuda):
    """The cohort step's graphs hold no reference back to their trainer, so
    a trainer that goes frees its device memory (the resident cohort, the
    static buffers, the graph pool) at once, not at the cycle collector's
    next pass."""
    import gc
    import weakref

    from repro_torch.federated.cohort import CohortTrainer, client_generators
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW

    clients = dp_clients(np.random.default_rng(3), [5, 30, 1, 70, 12])
    gc.collect()
    gc.disable()
    try:
        trainer = CohortTrainer(gru.make_loss_fn(gru.GRUConfig(dropout=0.05)), AdamW(), 8, 2,
                                staging="resident", device=cuda)
        params = gru.init_gru(torch.Generator().manual_seed(0), gru.GRUConfig(), cuda)
        gens = client_generators(np.random.default_rng(0), len(clients), cuda)
        trainer.train_cohort(params, clients, np.random.default_rng(0), gens)
        assert trainer.last_round_stats["captures"] == 3   # widths 2, 4 and 5
        gone = weakref.ref(trainer)
        del trainer
        assert gone() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("dp", [False, True], ids=["no-dp", "dp"])
def test_captured_local_and_central_steps_replay_the_eager_bits(cuda, dp):
    from repro_torch.capture import disable_capture
    from repro_torch.federated.central import CentralConfig, train_central
    from repro_torch.federated.client import LocalTrainer
    from repro_torch.models import gru
    from repro_torch.optim.adamw import AdamW
    from repro_torch.privacy.dp import DPConfig
    from repro_torch.tree import tree_leaves

    cfg = gru.GRUConfig(dropout=0.05)
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, cuda)
    clients = dp_clients(np.random.default_rng(1), [70, 5, 33])
    out = {}
    for mode in ("captured", "eager"):
        with disable_capture() if mode == "eager" else contextlib.nullcontext():
            trainer = LocalTrainer(gru.make_loss_fn(cfg), AdamW(), 16, 2, device=cuda,
                                   dp=DPConfig(1.0, 1.0) if dp else None)
            rng = np.random.default_rng(0)
            runs = []
            for i, client in enumerate(clients):
                gen = torch.Generator(device=cuda).manual_seed(i)
                p, loss, _ = trainer.train_client(params, client, rng, gen)
                runs.append((p, loss, gen.get_offset()))
            central = train_central(CentralConfig(epochs=2, batch_size=16), clients[0].train,
                                    params, gru.make_loss_fn(cfg), AdamW(), device=cuda)
            out[mode] = (runs, central, trainer.graphs.captures, trainer.graphs.replays)
    (runs_c, central_c, captures, replays), (runs_e, central_e, none, _) = (
        out["captured"], out["eager"])
    for (p_c, l_c, o_c), (p_e, l_e, o_e) in zip(runs_c, runs_e):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_c), tree_leaves(p_e)))
        assert l_c == l_e and o_c == o_e
    assert (captures, none) == (1, 0) and replays == sum(2 * -(-len(c.train) // 16)
                                                        for c in clients)
    assert central_c.epoch_losses == central_e.epoch_losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(central_c.params),
                                                 tree_leaves(central_e.params)))
    assert (central_c.captures, central_c.replays) == (1, central_c.total_steps)


@pytest.mark.parametrize("n", [128, 1000])
def test_wide_gru_kernels_capture_in_global_mode(cuda, n):
    """The wide kernels' host calls (cudaGetDevice, cudaDeviceGetAttribute,
    cudaFuncSetAttribute above 48 KB of shared memory) are legal under a
    global-mode capture: the replayed layer gives the eager bits."""
    from repro_torch.kernels.gru_scan.ops import GRUScan

    xg, w, b, _ = inputs(cuda, 4, 8, n, lead=(2,))
    w = w * min(1.0, 1.0 / (0.3 * n ** 0.5))
    dy = torch.randn(2, 4, 8, n, device=cuda)

    def body():
        x = xg.clone().requires_grad_(True)
        h = GRUScan.apply(x, w, b)
        (dx,) = torch.autograd.grad(h, x, dy)
        return h.detach(), dx

    h_e, dx_e = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        h_g, dx_g = body()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(h_g, h_e) and torch.equal(dx_g, dx_e)


LM_CAPTURE_CASES = {
    # name -> (arch, changes to its reduced config)
    "smollm-window5": ("smollm-135m", {"sliding_window": 5}),
    "mamba2-130m": ("mamba2-130m", {}),
    "zamba2-5layers": ("zamba2-7b", {"num_layers": 5}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    "llama4-moe-every2": ("llama4-scout-17b-a16e", {"num_layers": 5, "moe_every": 2}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
}


def lm_case(cuda, name, dtype=None):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import Model

    arch, changes = LM_CAPTURE_CASES[name]
    cfg = get_config(arch).reduced()
    if "moe_every" in changes:
        changes = {**changes, "moe": dataclasses.replace(cfg.moe, moe_every=changes["moe_every"])}
        del changes["moe_every"]
    cfg = dataclasses.replace(cfg, **changes, **({"dtype": dtype} if dtype else {}))
    return cfg, lambda: Model(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)


@pytest.mark.parametrize("name", list(LM_CAPTURE_CASES))
def test_captured_serve_steps_replay_the_eager_bits(cuda, name):
    """``make_serve_step`` captured (the cache donated, one graph for every
    position) against ``disable_capture()``: every step's logits and the
    cache bit for bit, one capture and a replay a later step."""
    from repro_torch.capture import disable_capture
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.zoo import Model
    from repro_torch.tree import tree_leaves

    cfg, init = lm_case(cuda, name)
    model = Model(cfg)
    params = init()
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12))).to(cuda)
    src = torch.from_numpy(rng.normal(size=(3, 9, cfg.d_model)).astype(np.float32)).to(cuda)
    out = {}
    for mode in ("captured", "eager"):
        with disable_capture() if mode == "eager" else contextlib.nullcontext():
            serve = make_serve_step(model)
            cache = model.init_cache(3, 12, cuda)
            if cfg.arch_type.value == "encdec":
                with torch.inference_mode():
                    cache = model.encode_for_decode(params, src, cache)
            pointers = [t.data_ptr() for t in tree_leaves(cache)]
            logits = []
            for t in range(12):
                lg, back = serve(params, toks[:, t:t + 1], cache, t)
                assert back is cache
                logits.append(lg)
            assert [t.data_ptr() for t in tree_leaves(cache)] == pointers
            graphs = serve.graphs(cuda)
            out[mode] = (torch.stack(logits), cache, graphs.captures, graphs.replays)
    (lg_c, cache_c, captures, replays), (lg_e, cache_e, none, _) = out["captured"], out["eager"]
    assert torch.equal(lg_c, lg_e)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache_c), tree_leaves(cache_e)))
    assert (captures, replays, none) == (1, 11, 0)


@pytest.mark.parametrize("name,dtype", [("mamba2-130m", "float32"), ("zamba2-5layers", "bfloat16"),
                                        ("deepseek-v3-671b", "bfloat16")])
def test_captured_train_steps_replay_the_eager_bits(cuda, name, dtype):
    """``make_train_step`` captured (params and AdamW moments updated in
    place, remat and the chunked CE's checkpoints inside the graph) against
    ``disable_capture()``: params, moments and metrics bit for bit after 3
    steps, the SSD launches equal; a cloned tree through the same graph
    gets its own step and leaves the capturing tree as it was."""
    from repro_torch.capture import disable_capture
    from repro_torch.data.pipeline import lm_token_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.zoo import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.tree import tree_leaves, tree_map

    cfg, init = lm_case(cuda, name, dtype)
    model = Model(cfg, loss_chunk=16)
    opt = AdamW(1e-2, clip_norm=1.0, schedule=cosine_schedule(1, 4))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             lm_token_batch(np.random.default_rng(3), 2, 40, cfg.vocab_size).items()}
    out = {}
    for mode in ("captured", "eager"):
        with disable_capture() if mode == "eager" else contextlib.nullcontext():
            step = make_train_step(model, opt)
            params = init()
            state = opt.init(params)
            before = (ssd_kernel.ssd_chunk_scan.launches, ssd_kernel.ssd_chunk_scan_bwd.launches)
            metrics = []
            for _ in range(3):
                params, state, m = step(params, state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            launches = (ssd_kernel.ssd_chunk_scan.launches - before[0],
                        ssd_kernel.ssd_chunk_scan_bwd.launches - before[1])
            graphs = step.graphs(cuda)
            out[mode] = (step, (params, state.mu, state.nu), metrics, launches, graphs.captures,
                         graphs.replays)
    (step, trees_c, m_c, n_c, captures, replays), (_, trees_e, m_e, n_e, none, _) = (
        out["captured"], out["eager"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(trees_c), tree_leaves(trees_e)))
    assert m_c == m_e and n_c == n_e and (captures, replays, none) == (1, 2, 0)
    held = tree_map(torch.clone, trees_c)
    other = init()
    other, other_state, m = step(other, opt.init(other), batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(trees_c), tree_leaves(held)))
    assert float(m["loss"]) == m_c[0]["loss"]


def test_captured_predict_replays_the_eager_bits(cuda):
    from repro_torch.capture import disable_capture
    from repro_torch.data.pipeline import ArrayDataset
    from repro_torch.experiments.paper import _predict
    from repro_torch.models import gru

    cfg = gru.GRUConfig()
    params = gru.init_gru(torch.Generator().manual_seed(0), cfg, cuda)
    rng = np.random.default_rng(4)
    data = ArrayDataset(rng.normal(size=(5000, 24, cfg.input_dim)).astype(np.float32),
                        rng.uniform(1, 9, size=5000).astype(np.float32))
    before = kernel.gru_scan.launches
    got = _predict(params, cfg, data)
    captured = kernel.gru_scan.launches - before
    with disable_capture():
        want = _predict(params, cfg, data)
    assert np.array_equal(got, want) and got.shape == (5000,)
    assert captured == kernel.gru_scan.launches - before - captured == 2 * 3
