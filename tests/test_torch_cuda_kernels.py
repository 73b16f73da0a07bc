"""The CUDA kernels (gru_scan, ssd_chunk_scan) on the card against their
plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: gru_scan forward and dx_gates 1e-5; dW_hh / db_hh 1e-4 times
max(1, max|ref|), as sums over B*T terms taken in another order;
ssd_chunk_scan 1e-4 times max(1, max|ref|), as sums over up to L*N and
L*P products taken in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ops import GRUScan  # noqa: E402
from repro_torch.kernels.gru_scan.ref import gru_scan_bwd_ref, gru_scan_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref, ssd_chunk_states_ref  # noqa: E402

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
     ((), 64, 24, 64), ((), 37, 5, 2)],
)
def test_kernels_match_plain_versions(cuda, lead, b, t, n):
    xg, w, bias, dy = inputs(cuda, b, t, n, lead=lead)
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    h = kernel.gru_scan(xg, w, bias)
    grads = kernel.gru_scan_bwd(xg, w, bias, h, dy)
    again = kernel.gru_scan_bwd(xg, w, bias, h, dy)
    torch.cuda.synchronize()
    assert (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert max_err(h, gru_scan_ref(xg, w, bias)) <= 1e-5
    ref = gru_scan_bwd_ref(xg, w, bias, h, dy)
    assert max_err(grads[0], ref[0]) <= 1e-5
    for g, r in zip(grads[1:], ref[1:]):
        assert max_err(g, r) <= 1e-4 * max(1.0, float(r.abs().max()))
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


def test_autograd_runs_both_kernels(cuda):
    xg, w, bias, dy = inputs(cuda, 16, 24, 32, seed=1)
    leaves = [x.requires_grad_(True) for x in (xg, w, bias)]
    before = (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches)
    h = GRUScan.apply(*leaves)
    grads = torch.autograd.grad(h, leaves, dy)
    assert (kernel.gru_scan.launches, kernel.gru_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = gru_scan_bwd_ref(xg.detach(), w.detach(), bias.detach(), h.detach(), dy)
    assert max_err(grads[0], ref[0]) <= 1e-5


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    xg, w, bias, _ = inputs(cuda, 4, 3, 2)
    with pytest.raises(TypeError):
        kernel.gru_scan(xg.double(), w.double(), bias.double())
    with pytest.raises(ValueError):
        kernel.gru_scan(xg.transpose(0, 1), w, bias)
    big = inputs(cuda, 2, 2, kernel.MAX_HIDDEN + 1)
    with pytest.raises(ValueError):
        kernel.gru_scan(*big[:3])
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


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = ssd_inputs(cuda, 1, 1, 8, 2, 4, 4)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_chunk_scan(*(a.double() for a in args))
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan(args[0].transpose(3, 4).contiguous().transpose(3, 4), *args[1:])
    with pytest.raises(ValueError):
        ssd_kernel.ssd_chunk_scan(args[0], args[1].cpu(), *args[2:])
    for shape in ((1, 1, 257, 1, 4, 4), (1, 1, 8, 1, 65, 4), (1, 1, 8, 1, 4, 129)):
        with pytest.raises(ValueError):
            ssd_kernel.ssd_chunk_scan(*ssd_inputs(cuda, *shape))
    leaves = [a.requires_grad_(True) for a in args]
    with pytest.raises(NotImplementedError, match="training slice"):
        ssd_ops.ssd_chunk_scan(*leaves)


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
