"""The work each kernel must do, the card's peaks, and the kernels' bounds.

One count serves two readers.  ``chip_smoke.py`` divides it by the card's
datasheet peaks for each kernel's ``bound_ms``, the least time the card
could take for the call.  The dry run (``launch/dryrun.py``) adds it to a
step's FLOPs and bytes where a kernel wrapper meets ``meta`` tensors: the
wrapper then launches nothing, returns empty outputs of the kernel's
shapes and dtypes, and calls :func:`record`, which hands the call's work
to every :func:`recording` open at the time.

The peaks are NVIDIA's datasheet figures for the H100 SXM5 (80 GB HBM3,
700 W), dense rates without sparsity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 on the tensor cores
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3   # three TF32 products a float32 product
PEAK_16BIT_FLOPS = 989e12    # H100 SXM dense bf16 and fp16 on the tensor cores


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time on this card: bytes over 3.35 TB/s or float32 ops over
    67 TFLOP/s, whichever is larger, and which it was."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tensor_core_ms(ops: int, mma: int, mma16: int = 0, elem: int = 4) -> float:
    """The least time for ``ops`` float ops of which ``mma`` are tile products
    on the tensor cores: in 3xTF32 at 495/3 TFLOP/s, except, with 16-bit
    inputs (``elem`` 2), the ``mma16`` of them whose operands are both
    16-bit inputs, which one bf16/fp16 product a product takes exactly, at
    989 TFLOP/s; the rest of ``ops`` at 67 TFLOP/s on the CUDA cores."""
    exact = mma16 if elem == 2 else 0
    return (exact / PEAK_16BIT_FLOPS + (mma - exact) / PEAK_3XTF32_FLOPS
            + (ops - mma) / PEAK_F32_FLOPS) * 1e3


def gru_work(b: int, t: int, n: int, elem: int = 4) -> tuple[int, int, int, int]:
    """Bytes each GRU kernel must move for one client (inputs once, outputs
    once, ``elem`` bytes an element) and its float ops: ``(fwd_bytes,
    fwd_ops, bwd_bytes, bwd_ops)``.

    Forward per (row, step): the (1,N)x(N,3N) product (2*N*3N) and ~20 ops per
    unit for biases, two sigmoids, tanh and the blend.  Backward: the gate
    rebuild, d_gh W^T and h^T d_gh products (3 * 2*N*3N) and ~40 ops per unit.
    """
    f = elem
    w_bytes = f * (n * 3 * n + 3 * n)
    fwd_bytes = f * (b * t * 3 * n + b * t * n) + w_bytes
    bwd_bytes = f * (2 * b * t * 3 * n + 2 * b * t * n) + 2 * w_bytes
    fwd_ops = b * t * (2 * n * 3 * n + 20 * n)
    bwd_ops = b * t * (3 * 2 * n * 3 * n + 40 * n)
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def ssd_work(b: int, nc: int, l_len: int, h: int, p: int, n: int,
             elem: int = 4) -> tuple[int, int, int, int, int]:
    """Bytes the call must move (inputs of ``elem`` bytes an element read
    once, y written once),
    its float ops counting the causal pairs l >= m of each L x L block that
    the scan needs (and, beside it, the full L x L block), how many of the
    causal count are tile products (C B^T, W x, C S and the state update:
    the kernels' tensor-core work), and how many of those take two of the
    inputs (C B^T).

    Per (batch, chunk): C B^T once, 2N per pair (shared by the heads).  Per
    head: the weights exp(cum_l - cum_m) dt_m G (a subtraction, an exp and
    two products: 4 per pair) and W x (2P per pair); the carried-state term
    C S and the state update (2NP per row each) and the per-row decays (4).
    """
    bytes_ = elem * (2 * b * nc * l_len * h * p + 2 * b * nc * l_len * h + 2 * b * nc * l_len * n)

    def ops_for(pairs: int, tile_products_only: bool = False) -> int:
        per_head = pairs * 2 * p + l_len * 4 * n * p
        if not tile_products_only:
            per_head += pairs * 4 + l_len * 4
        return b * nc * (2 * n * pairs + h * per_head)

    causal = l_len * (l_len + 1) // 2
    return (bytes_, ops_for(causal), ops_for(l_len * l_len), ops_for(causal, True),
            b * nc * 2 * n * causal)


def ssd_bwd_work(b: int, nc: int, l_len: int, h: int, p: int, n: int,
                 elem: int = 4) -> tuple[int, int, int, int]:
    """Bytes the backward must move, its float ops over the causal pairs, how
    many of those are tile products (the kernels' tensor-core work), and how
    many of those take two of the inputs (C B^T and dW = dy x^T).

    Bytes: x, dy, dt, cum, B, C (``elem`` bytes an element) and the float32
    entry states read once; dx, ddt, dcum, dB and dC written once.  Scratch
    that one implementation keeps (the kernels' G, dG and dS) is not the
    function's.
    Per (batch, chunk) and causal pair, shared by the heads: C B^T
    recomputed, and dC = dG B, dB = dG^T C from the head-summed dG (2N
    each).  Per head and pair: dW = dy x^T and dx = W^T dy (2P each) and ~10
    for the decay, the weights and the dt and cum sums.  Per head and row,
    four products of 2NP each: U = (e dy) S (dC's carried term), V = B dS^T
    (dx's state term), Z = x dS (dB's) and the update of dS; the y_inter term
    of dcum is C . U (2N) and g is x . V (2P); ~10 for the decays.  The
    tile products are the 2N and 2P per pair and the 2NP per row.
    """
    rows = b * nc * l_len
    bytes_ = elem * (3 * rows * h * p + 4 * rows * h + 4 * rows * n) + 4 * b * nc * h * p * n
    pairs = l_len * (l_len + 1) // 2
    per_head = pairs * (4 * p + 10) + l_len * (8 * n * p + 2 * n + 2 * p + 10)
    mma_per_head = pairs * 4 * p + l_len * 8 * n * p
    return (bytes_, b * nc * (3 * 2 * n * pairs + h * per_head),
            b * nc * (3 * 2 * n * pairs + h * mma_per_head),
            b * nc * pairs * (2 * n + h * 2 * p))


# ---------------------------------------------------------------------------
# The meta route's record of kernel work.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelWork:
    """The work of one kernel's calls on the meta route, summed."""

    calls: int = 0
    flops: int = 0          # float ops, as the bounds count them
    bytes: int = 0          # inputs read once, outputs written once
    compute_s: float = 0.0  # the ops at the card's peaks (the bound's compute term)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_open: list[dict[str, KernelWork]] = []


@contextlib.contextmanager
def recording() -> Iterator[dict[str, KernelWork]]:
    """Collect, by kernel name, the work of every kernel call that the meta
    route takes inside the block."""
    log: dict[str, KernelWork] = {}
    _open.append(log)
    try:
        yield log
    finally:
        del _open[next(i for i, other in enumerate(_open) if other is log)]


def record(name: str, nbytes: int, flops: int, compute_s: float) -> None:
    """Add one call of kernel ``name`` to every open :func:`recording`."""
    for log in _open:
        work = log.setdefault(name, KernelWork())
        work.calls += 1
        work.flops += flops
        work.bytes += nbytes
        work.compute_s += compute_s


def record_gru(name: str, c: int, b: int, t: int, n: int, elem: int) -> None:
    """One call of ``gru_scan`` or ``gru_scan_bwd`` over ``c`` clients."""
    fwd_bytes, fwd_ops, bwd_bytes, bwd_ops = gru_work(b, t, n, elem)
    nbytes, ops = (fwd_bytes, fwd_ops) if name == "gru_scan" else (bwd_bytes, bwd_ops)
    record(name, c * nbytes, c * ops, c * ops / PEAK_F32_FLOPS)


def record_ssd(name: str, shape: tuple[int, ...], elem: int) -> None:
    """One call of ``ssd_chunk_scan`` or ``ssd_chunk_scan_bwd`` at
    ``shape`` = (B, NC, L, H, P, N)."""
    if name == "ssd_chunk_scan":
        nbytes, ops, _, mma, mma16 = ssd_work(*shape, elem=elem)
    else:
        nbytes, ops, mma, mma16 = ssd_bwd_work(*shape, elem=elem)
    record(name, nbytes, ops, tensor_core_ms(ops, mma, mma16, elem) / 1e3)
