"""The work a kernel call must do and the card's peaks: a frozen copy of
``repro_torch/kernels/work.py`` (``gru_work``, ``ssd_work``,
``ssd_bwd_work``, ``tensor_core_ms`` and the datasheet peaks), so that no
change to the program moves the denominators of a roofline or an MFU.

The peaks are NVIDIA's datasheet figures for the H100 SXM5 (80 GB HBM3,
700 W), dense rates without sparsity.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_16BIT_FLOPS = 989e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds: bytes over 3.35 TB/s or float32 ops over 67
    TFLOP/s, whichever is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def tensor_core_ms(ops: int, mma: int, mma16: int = 0, elem: int = 4) -> float:
    exact = mma16 if elem == 2 else 0
    return (exact / PEAK_16BIT_FLOPS + (mma - exact) / PEAK_3XTF32_FLOPS
            + (ops - mma) / PEAK_F32_FLOPS) * 1e3


def gru_work(b: int, t: int, n: int, elem: int = 4) -> tuple[int, int, int, int]:
    """``(fwd_bytes, fwd_ops, bwd_bytes, bwd_ops)`` of one client's GRU
    forward and backward over ``b`` rows: inputs once, outputs once."""
    f = elem
    w_bytes = f * (n * 3 * n + 3 * n)
    fwd_bytes = f * (b * t * 3 * n + b * t * n) + w_bytes
    bwd_bytes = f * (2 * b * t * 3 * n + 2 * b * t * n) + 2 * w_bytes
    fwd_ops = b * t * (2 * n * 3 * n + 20 * n)
    bwd_ops = b * t * (3 * 2 * n * 3 * n + 40 * n)
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def ssd_work(b: int, nc: int, l_len: int, h: int, p: int, n: int,
             elem: int = 4) -> tuple[int, int, int, int, int]:
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
    rows = b * nc * l_len
    bytes_ = elem * (3 * rows * h * p + 4 * rows * h + 4 * rows * n) + 4 * b * nc * h * p * n
    pairs = l_len * (l_len + 1) // 2
    per_head = pairs * (4 * p + 10) + l_len * (8 * n * p + 2 * n + 2 * p + 10)
    mma_per_head = pairs * 4 * p + l_len * 8 * n * p
    return (bytes_, b * nc * (3 * 2 * n * pairs + h * per_head),
            b * nc * (3 * 2 * n * pairs + h * mma_per_head),
            b * nc * pairs * (2 * n + h * 2 * p))


def gru_round_bound_s(samples: int, calls: int, t: int, n: int, layers: int) -> float:
    """The least seconds of a round's GRU work as the setting requires it:
    ``samples`` real rows and ``calls`` weight sets (a client's real step,
    or under DP each example's own copy), forward and backward, each layer."""
    fb0, fo0, bb0, bo0 = gru_work(0, t, n)
    fb, fo, bb, bo = gru_work(samples, t, n)
    fwd = bound_s(fb - fb0 + fb0 * calls, fo)
    bwd = bound_s(bb - bb0 + bb0 * calls, bo)
    return layers * (fwd + bwd)


def model_flops(params: int, tokens: int) -> float:
    """6 N D: a forward and a backward of ``params`` over ``tokens``."""
    return 6.0 * params * tokens
