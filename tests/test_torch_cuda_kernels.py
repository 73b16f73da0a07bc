"""The CUDA gru_scan kernels on the card against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: forward and dx_gates 1e-5; dW_hh / db_hh 1e-4 times
max(1, max|ref|), as sums over B*T terms taken in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gru_scan import kernel  # noqa: E402
from repro_torch.kernels.gru_scan.ops import GRUScan  # noqa: E402
from repro_torch.kernels.gru_scan.ref import gru_scan_bwd_ref, gru_scan_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gru_scan kernels run only on the card")
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
