"""The SSD kernels' whole contract against the JAX package, on the CPU:
bfloat16 and float16, mixed dtypes, chunk, head and state sizes above
L = 256, P = 64 and N = 128, more than 65,535 (batch, chunk) rows, and a
Mamba2 at a user's ``SSMConfig`` above those sizes.

On the CPU the wrappers run their plain versions (``ref.py``); they are held
against the Pallas kernels in interpret mode, as the JAX package's own
tests run them, and against ``ssd_full`` under ``jax.grad``, on the same
numpy inputs from a seed.  At 70,000 rows the references are JAX's
``ssd_chunk_scan_ref`` and ``ssd_ref``: interpret mode walks the grid one
cell at a time.  The CUDA kernels behind the same wrappers (the bfloat16
and float16 instantiations, P in 64-column tiles, N in any number of
halves, the rows in launches of at most 65,535) are held against the plain
versions on the card by ``tests/test_torch_cuda_kernels.py`` and phase 28
of ``chip_smoke.py``.

Tolerances: float32 1e-5 times max(1, max|ref|); bfloat16 and float16 3e-2
times max(1, max|ref|), the reference's own (``tests/test_kernels.py``),
as both packages compute in float32 and round each output once, and round
the inputs' elementwise products (dt A and its cumsum) in the dtype at
their own places.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ssd import kernel as jax_kernel  # noqa: E402
from repro.kernels.ssd import ref as jax_ref  # noqa: E402
from repro.kernels.ssd.ops import ssd_full as jax_ssd_full  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd import kernel, ref  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_full  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
LOW_TOL = 3e-2
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}


def chunked(b, nc, l_len, h, p, n, seed=0):
    """x, dt, cum, B, C (chunked layout) and dy, float32 numpy from a seed."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, nc, l_len, h))))
    a = -np.exp(rng.normal(size=(h,)) * 0.5) * 0.05
    arrays = (rng.normal(size=(b, nc, l_len, h, p)), dt, np.cumsum(dt * a, axis=2),
              rng.normal(size=(b, nc, l_len, n)), rng.normal(size=(b, nc, l_len, n)),
              rng.normal(size=(b, nc, l_len, h, p)))
    return [x.astype(np.float32) for x in arrays]


def unchunked(b, s, h, p, n, seed=0):
    """x, dt, A, B, C of ``ssd_full``, as the reference's own test draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h))))
    a = -np.exp(rng.normal(size=(h,)) * 0.3)
    bm, cm = rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


def as_pair(arrays, jdt, tdt):
    """The same values on both sides: rounded to ``jdt`` by JAX, then carried
    across exactly."""
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jargs]
    return jargs, targs


def close(got, ref, tol=TOL):
    got, ref = (a.detach().float().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in (got, ref))
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - ref))) <= tol * max(1.0, float(np.max(np.abs(ref))))


def same_dtype(t, j):
    assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,chunk", [(23, 8), (37, 16)])
def test_low_precision_ssd_full_and_grad_match_jax(dtype, s, chunk):
    """bfloat16 and float16 through ``ssd_full``: y against the Pallas
    kernel, and the gradients of x, dt, B and C under ``jax.grad`` (the
    reference's own cases), each in the inputs' dtype."""
    tdt, jdt = DTYPES[dtype]
    jargs, targs = as_pair(unchunked(1, s, 2, 8, 8, seed=s), jdt, tdt)
    y = ssd_full(*targs, chunk=chunk)
    y_ref = jax_ssd_full(*jargs, chunk=chunk)
    same_dtype(y, y_ref)
    assert y.dtype == tdt
    close(y, y_ref, LOW_TOL)

    def loss(xx, dd, bb, cc):
        return jnp.sum(jax_ssd_full(xx, dd, jargs[2], bb, cc, chunk=chunk).astype(jnp.float32) ** 2)

    ref_grads = jax.grad(loss, argnums=(0, 1, 2, 3))(jargs[0], jargs[1], jargs[3], jargs[4])
    leaves = [targs[i].clone().requires_grad_(True) for i in (0, 1, 3, 4)]
    out = ssd_full(leaves[0], leaves[1], targs[2], leaves[2], leaves[3], chunk=chunk)
    got = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    for g, r, a in zip(got, ref_grads, leaves):
        assert g.dtype == a.dtype == tdt
        same_dtype(g, r)
        close(g, r, LOW_TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_low_precision_residual_backward_matches_pallas(dtype):
    """The chunked forward with its entry states and the residual backward in
    bfloat16 / float16 against the Pallas kernels on the same inputs: y and
    every cotangent in the inputs' dtype, the states in float32."""
    tdt, jdt = DTYPES[dtype]
    *args, dy = chunked(2, 3, 16, 3, 8, 16, seed=5)
    jargs, targs = as_pair([*args, dy], jdt, tdt)
    y, states = kernel.ssd_chunk_scan(*targs[:5], return_states=True)
    y_ref, s_ref = jax_kernel.ssd_chunk_scan(*jargs[:5], h_tile=1, return_states=True)
    assert y.dtype == tdt and states.dtype == torch.float32
    same_dtype(y, y_ref)
    close(y, y_ref, LOW_TOL)
    close(states, s_ref, LOW_TOL)
    got = kernel.ssd_chunk_scan_bwd(*targs[:5], states, targs[5])
    want = jax_kernel.ssd_chunk_scan_bwd(*jargs[:5], jnp.asarray(states.numpy()), jargs[5])
    for g, r, a in zip(got, want, targs):
        assert g.dtype == a.dtype
        same_dtype(g, r)
        close(g, r, LOW_TOL)


def test_mixed_dtypes_take_each_inputs_dtype():
    """x and dy in bfloat16, dt and cum in float32, B and C in float16: y in
    x's dtype and each cotangent in its input's, as the Pallas kernels
    store them, the values those of the float32 computation."""
    *args, dy = chunked(1, 2, 16, 2, 8, 8, seed=9)
    dtypes = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
              (torch.float32, jnp.float32), (torch.float16, jnp.float16),
              (torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16)]
    pairs = [as_pair([a], jdt, tdt) for a, (tdt, jdt) in zip([*args, dy], dtypes)]
    jargs, targs = [p[0][0] for p in pairs], [p[1][0] for p in pairs]
    y, states = kernel.ssd_chunk_scan(*targs[:5], return_states=True)
    y_ref, s_ref = jax_kernel.ssd_chunk_scan(*jargs[:5], h_tile=1, return_states=True)
    same_dtype(y, y_ref)
    close(y, y_ref, LOW_TOL)
    close(states, s_ref, TOL)
    # The values are the float32 computation's on the same (exact) inputs.
    close(y, kernel.ssd_chunk_scan(*(t.float() for t in targs[:5])).to(torch.bfloat16))
    got = kernel.ssd_chunk_scan_bwd(*targs[:5], states, targs[5])
    want = jax_kernel.ssd_chunk_scan_bwd(*jargs[:5], jnp.asarray(states.numpy()), jargs[5])
    for g, r, a in zip(got, want, targs):
        assert g.dtype == a.dtype
        same_dtype(g, r)
        close(g, r, LOW_TOL)


@pytest.fixture(scope="module")
def above_caps():
    """L = 512, P = 128, N = 256 at B = 1, H = 2, NC = 2 (float32)."""
    arrays = chunked(1, 2, 512, 2, 128, 256, seed=13)
    return arrays, [torch.from_numpy(a) for a in arrays]


def test_above_the_old_sizes_matches_pallas(above_caps):
    """The forward, its entry states and the residual backward at a chunk of
    512, head dim 128 and state 256 against the Pallas kernels."""
    arrays, targs = above_caps
    y, states = kernel.ssd_chunk_scan(*targs[:5], return_states=True)
    y_ref, s_ref = jax_kernel.ssd_chunk_scan(*arrays[:5], h_tile=2, return_states=True)
    close(y, y_ref)
    close(states, s_ref)
    got = kernel.ssd_chunk_scan_bwd(*targs[:5], states, targs[5])
    want = jax_kernel.ssd_chunk_scan_bwd(*arrays[:5], np.asarray(s_ref), arrays[5])
    for g, r in zip(got, want):
        close(g, r)


def test_stages_above_the_old_sizes_match_jax(above_caps):
    """The kernels' stage composition (what the card holds each stage kernel
    against) at the same sizes, against JAX's chunked scan and backward."""
    arrays, targs = above_caps
    y, states = ref.ssd_chunk_scan_stages_ref(*targs[:5])
    close(y, jax_ref.ssd_chunk_scan_ref(*arrays[:5]))
    grads = ref.ssd_chunk_scan_bwd_stages_ref(*targs[:5], states, targs[5])
    want = jax_ref.ssd_chunk_scan_bwd_ref(*arrays[:5], states.numpy(), arrays[5])
    for g, r in zip(grads, want):
        close(g, r)


def test_more_than_65535_batch_rows_match_jax():
    """70,000 (batch, chunk) rows as 70,000 batch rows of one chunk: the
    forward, the entry states and the residual backward against JAX's
    chunked references."""
    arrays = chunked(70_000, 1, 4, 2, 2, 2, seed=17)
    targs = [torch.from_numpy(a) for a in arrays]
    y, states = kernel.ssd_chunk_scan(*targs[:5], return_states=True)
    close(y, jax_ref.ssd_chunk_scan_ref(*arrays[:5]))
    assert not bool(states.any())  # one chunk: every entry state is S_0 = 0
    got = kernel.ssd_chunk_scan_bwd(*targs[:5], states, targs[5])
    want = jax_ref.ssd_chunk_scan_bwd_ref(*arrays[:5], states.numpy(), arrays[5])
    for g, r in zip(got, want):
        close(g, r)


def test_more_than_65535_chunks_match_jax():
    """70,000 (batch, chunk) rows as 70,000 chunks of one sequence, through
    the stage composition (one pass over the chunks), against JAX's
    step-by-step ``ssd_ref`` on the unchunked sequence."""
    b, nc, l_len, h, p, n = 1, 70_000, 4, 1, 2, 2
    x, dt, a, bm, cm = unchunked(b, nc * l_len, h, p, n, seed=19)
    a = a * 0.05
    want = jax_ref.ssd_ref(x, dt, a, bm, cm)
    xc = torch.from_numpy(x).reshape(b, nc, l_len, h, p)
    dtc = torch.from_numpy(dt).reshape(b, nc, l_len, h)
    cum = torch.cumsum(dtc * torch.from_numpy(a), dim=2)
    bc = torch.from_numpy(bm).reshape(b, nc, l_len, n)
    cc = torch.from_numpy(cm).reshape(b, nc, l_len, n)
    y, _ = ref.ssd_chunk_scan_stages_ref(xc, dtc, cum, bc, cc)
    close(y.reshape(b, nc * l_len, h, p), want)


# A user's SSMConfig above every old size: head_dim 128 (P), d_state 256 (N)
# and a chunk of 512 (L), at the reduced config's other widths (d_model 256:
# 4 heads) and 2 layers; S = 520 makes two chunks, the second ragged.
SSM_ABOVE = dict(head_dim=128, d_state=256, chunk_size=512)
B, S = 2, 520


@pytest.fixture(scope="module")
def user_config():
    def config(get):
        cfg = get("mamba2-130m").reduced()
        return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **SSM_ABOVE))

    jcfg, tcfg = config(jax_get_config), config(get_config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.tree.map(np.asarray, jax_zoo.Model(jcfg).init(jax.random.key(3)))
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, tcfg, jparams, batch


def test_mamba2_above_the_old_sizes_logits_match_jax(user_config):
    jcfg, tcfg, jparams, batch = user_config
    want = jax_zoo.Model(jcfg, use_pallas=True, remat=False).forward_logits(
        jparams, {"tokens": batch["tokens"]})
    got = zoo.Model(tcfg).forward_logits(zoo.params_from_jax(jparams, "cpu"),
                                         {"tokens": torch.from_numpy(batch["tokens"])})
    close(got, want)


def test_mamba2_above_the_old_sizes_gradients_match_jax(user_config):
    """Every gradient leaf of the loss against ``jax.grad`` through the
    reference's Pallas scan and its residual backward."""
    jcfg, tcfg, jparams, batch = user_config
    jmodel = jax_zoo.Model(jcfg, use_pallas=True, remat=False, loss_chunk=128)
    want = jax.grad(lambda p: jmodel.loss(p, batch)[0])(jparams)
    params = zoo.params_from_jax(jparams, "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = zoo.Model(tcfg, remat=False, loss_chunk=128).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.autograd.grad(loss, leaves)
    want_leaves = jax.tree.leaves(want)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        close(g, w)
