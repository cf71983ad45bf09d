"""Port parity: the Mamba-2 SSD scan and mixer against the JAX package.

The same inputs, drawn with numpy, go through `repro.nn.ssm` /
`repro.kernels.ssd_scan` and their ports. The JAX Pallas kernel runs in
interpret mode, as the JAX package's own tests run it on the CPU; the
port's kernel wrapper takes its plain version on a CPU tensor.

Tolerances: 1e-5 where both sides run the same chunked algorithm in
float32 (sums in another order); 1e-4 against the kernel or the
sequential recurrence (as `tests/test_kernels.py` holds the Pallas
kernel to the chunked reference), 0.05 for bfloat16 outputs. The CUDA
kernel's decomposition (csrc/ssd_scan.cu) is mirrored in plain torch
and held to the same 1e-4 and 0.05, with its 3xTF32 products emulated
by bit operations.
"""
import ctypes
import functools
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro.nn import ssm as jssm
from repro_torch import interop
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.nn import ssm
from torch_tf32 import matmul_tf32, tf32
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (b, s, h, p, g, n, chunk): s % chunk != 0, g = 2, chunk > s, s == chunk
SCAN_CASES = {
    "s40-chunk16-g2": (2, 40, 4, 32, 2, 16, 16),
    "s32-chunk8-g1": (1, 32, 2, 32, 1, 8, 8),
    "s7-chunk8-g4": (2, 7, 4, 64, 4, 8, 8),
    "s16-chunk16-g1": (1, 16, 3, 32, 1, 16, 16),
}


def scan_inputs(b, s, h, p, g, n, *, seed=0, dt=None, A=None):
    """x, dt (softplus of normals), A (negative), B, C as float32 numpy,
    the distribution of `tests/test_kernels.py::TestSSDScan`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dts = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) if dt is None
           else np.full((b, s, h), dt)).astype(np.float32)
    As = (-np.exp(rng.standard_normal(h) * 0.4) if A is None
          else np.full(h, A)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dts, As, B, C


def torch_args(arrays, requires_grad=False):
    return [torch.tensor(a, requires_grad=requires_grad) for a in arrays]


def jax_sequential_scan(x, dt, A, B, C):
    """The JAX package's sequential recurrence (`ssd_ref`) behind the
    mixer layout, a = dt * A folded inside, so jax.grad reaches dt and A."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    xk = jnp.moveaxis(x, 2, 1).reshape(b * h, s, p)
    dtk = jnp.moveaxis(dt, 2, 1).reshape(b * h, s)
    ak = dtk * jnp.tile(A, b)[:, None]
    Bk, Ck = (jnp.moveaxis(jnp.repeat(t, rep, axis=2), 2, 1)
              .reshape(b * h, s, t.shape[-1]) for t in (B, C))
    y, state = jref.ssd_ref(xk, dtk, ak, Bk, Ck)
    return (jnp.moveaxis(y.reshape(b, h, s, p), 1, 2),
            state.reshape(b, h, *state.shape[1:]))


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_chunked_scan_matches_jax(case):
    b, s, h, p, g, n, chunk = SCAN_CASES[case]
    arrays = scan_inputs(b, s, h, p, g, n)
    jy, jstate = jssm.ssd_scan_ref(*map(jnp.asarray, arrays), chunk=chunk,
                                   return_final_state=True)
    ty, tstate = ssm.ssd_scan_ref(*torch_args(arrays), chunk=chunk,
                                  return_final_state=True)
    assert ty.shape == (b, s, h, p) and tstate.shape == (b, h, n, p)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=1e-5,
                               atol=1e-5)


def test_kernel_plain_version_matches_jax_ssd_ref():
    """`ref.ssd_ref` is the twin of the JAX `ssd_ref`, in the kernel
    layout (BH, S, ...) with a = dt * A folded."""
    rng = np.random.default_rng(1)
    bh, s, p, n = 6, 20, 8, 4
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s)))).astype(np.float32)
    a = (dt * -np.exp(rng.standard_normal((bh, 1)) * 0.4)).astype(np.float32)
    B, C = (rng.standard_normal((bh, s, n)).astype(np.float32)
            for _ in range(2))
    jy, jstate = jref.ssd_ref(*map(jnp.asarray, (x, dt, a, B, C)))
    ty, tstate = ref.ssd_ref(*torch_args((x, dt, a, B, C)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_wrapper_matches_jax_interpret_kernel(case, dtype):
    """The port's wrapper on a CPU tensor (its plain version) against the
    JAX Pallas kernel in interpret mode: y and the final state."""
    b, s, h, p, g, n, chunk = SCAN_CASES[case]
    x, dt, A, B, C = scan_inputs(b, s, h, p, g, n, seed=2)
    jdtype, tdtype = ((jnp.float32, torch.float32) if dtype == "float32"
                      else (jnp.bfloat16, torch.bfloat16))
    jy, jstate = jops.ssd_scan(jnp.asarray(x, jdtype), *map(
        jnp.asarray, (dt, A, B, C)), chunk=chunk, return_final_state=True,
        interpret=True)
    tx = torch.tensor(x).to(tdtype)
    ty, tstate = ops.ssd_scan(tx, *torch_args((dt, A, B, C)), chunk=chunk,
                              return_final_state=True)
    assert ty.dtype == tdtype and tstate.dtype == torch.float32
    atol = 1e-4 if dtype == "float32" else 0.05
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=0, atol=atol)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=0,
                               atol=1e-4 if dtype == "float32" else 0.05)
    np.testing.assert_array_equal(
        ops.ssd_scan(tx, *torch_args((dt, A, B, C)), chunk=chunk).float(),
        ty.float())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, B, C = torch_args(scan_inputs(1, 8, 2, 32, 1, 4))
    with pytest.raises(ValueError, match="zero state"):
        ops.ssd_scan(x, dt, A, B, C, chunk=8,
                     initial_state=torch.zeros(1, 2, 4, 32))
    with pytest.raises(ValueError, match="shapes"):
        ops.ssd_scan(x, dt[:, :4], A, B, C, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops._kernel_forward(x, dt, A, B, C, 8, False)


def test_ctypes_signature_matches_the_cuda_entry_point():
    """The wrapper's argtypes against `extern "C" int ssd_scan(...)` in
    csrc/ssd_scan.cu: one ctypes type per C parameter, of its kind."""
    src = (pathlib.Path(ops.__file__).parents[2] / "csrc"
           / "ssd_scan.cu").read_text()
    decl = re.search(r'extern "C" int ssd_scan\(([^)]*)\)', src).group(1)
    params = [" ".join(p.split()) for p in decl.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
             for p in params]
    assert ops.ARGTYPES == kinds


def test_default_scan_follows_the_device():
    assert ssm.default_scan(torch.device("cpu")) is ssm.ssd_scan_ref
    assert ssm.default_scan(torch.device("cuda")) is ops.ssd_scan
    # a dry run on the meta device stands in for the card
    assert ssm.default_scan(torch.device("meta")) is ops.ssd_scan
    with pytest.raises(ValueError):
        ssm.default_scan(torch.device("xpu"))


MIXER = dict(d_state=8, head_dim=16, expand=2, n_groups=2, chunk=8)


@pytest.mark.parametrize("scan", ["chunked", "wrapper"])
def test_mixer_forward_and_gradients_match_jax(scan):
    """Forward and the gradients of every parameter and of x against
    jax.grad; "wrapper" runs the port's kernel Function (plain forward
    on the CPU, backward through the chunked scan)."""
    d_model, b, s = 32, 2, 20
    kw = MIXER
    jparams = jssm.ssd_mixer_init(jax.random.PRNGKey(3), d_model,
                                  **{k: v for k, v in kw.items()
                                     if k != "chunk"})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, d_model)).astype(np.float32)
    cot = rng.standard_normal((b, s, d_model)).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jssm.ssd_mixer_apply(params, x, **kw) * cot)

    jval, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jparams, jnp.asarray(x))
    tparams = interop.to_torch(jax.device_get(jparams), "cpu")
    leaves = {k: v.requires_grad_() for k, v in tparams.items()
              if k != "norm"}
    tparams["norm"]["scale"].requires_grad_()
    tx = torch.tensor(x, requires_grad=True)
    impl = None if scan == "chunked" else ops.ssd_scan
    y = ssm.ssd_mixer_apply(tparams, tx, scan_impl=impl, **kw)
    loss = torch.sum(y * torch.from_numpy(cot))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jgp[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tparams["norm"]["scale"].grad.numpy(),
                               np.asarray(jgp["norm"]["scale"]), rtol=1e-4,
                               atol=1e-4)


def test_mixer_refuses_the_serving_paths():
    """return_state (prefill), once refused, gives JAX's decode state;
    below d_conv - 1 tokens it raises, where the JAX package's conv tail
    would come out shorter than the cache (`repro/nn/ssm.py:247`)."""
    params = ssm.ssd_mixer_init(torch.Generator().manual_seed(0), 32,
                                d_state=8, head_dim=16)
    kw = dict(d_state=8, head_dim=16)
    x = np.random.default_rng(1).standard_normal((1, 4, 32)).astype(
        np.float32)
    jy, jstate = jssm.ssd_mixer_apply(
        jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(params)),
        jnp.asarray(x), return_state=True, **kw)
    ty, tstate = ssm.ssd_mixer_apply(params, torch.tensor(x),
                                     return_state=True, **kw)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(tstate[name].detach().numpy(),
                                   np.asarray(jstate[name]), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        ssm.ssd_mixer_apply(params, torch.tensor(x[:, :2]),
                            return_state=True, **kw)


# The reference's NaN-gradient trap: at chunk 128, dt = 0.05 and A = -16
# reach seg = cs_i - cs_l > 88.7 above the diagonal, where exp overflows.
GRAD_CASES = {"trap": (dict(b=1, s=128, h=2, p=4, g=1, n=4, seed=4, dt=0.05,
                            A=-16.0), 128),
              "normal": (dict(b=1, s=24, h=4, p=32, g=2, n=8, seed=6), 16)}


@functools.cache
def sequential_grads(case):
    """Inputs, cotangents of y and of the final state, and jax.grad of
    the sequential recurrence (JAX `ssd_ref`) for a GRAD_CASES entry."""
    kw, chunk = GRAD_CASES[case]
    arrays = scan_inputs(**kw)
    b, _, h, p = arrays[0].shape
    rng = np.random.default_rng(7)
    cot_y = rng.standard_normal(arrays[0].shape).astype(np.float32)
    cot_s = rng.standard_normal((b, h, kw["n"], p)).astype(np.float32)

    def loss(*args):
        y, state = jax_sequential_scan(*args)
        return jnp.sum(y * cot_y) + jnp.sum(state * cot_s)

    grad = jax.grad(loss, argnums=(0, 1, 2, 3, 4))
    if kw["s"] <= 32:
        # a short loop compiles faster than it runs op by op; the trap's
        # 128 steps are the other way round
        grad = jax.jit(grad)
    grads = grad(*map(jnp.asarray, arrays))
    return arrays, chunk, cot_y, cot_s, [np.asarray(g) for g in grads]


def _check_grads(targs, jgrads):
    for t, j, name in zip(targs, jgrads, "x dt A B C".split()):
        assert bool(torch.isfinite(t.grad).all()), name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_reference_trap_nan_gradient_is_finite_in_the_port():
    """JAX `ssd_scan_ref`'s dt-gradient is NaN here (exp on the upper
    triangle, then 0 * inf); the port masks before exp, so its gradient
    is finite and matches jax.grad of the sequential recurrence."""
    arrays, chunk, cot_y, cot_s, jgrads = sequential_grads("trap")

    def jloss(*args):
        y, state = jssm.ssd_scan_ref(*args, chunk=chunk,
                                     return_final_state=True)
        return jnp.sum(y * cot_y) + jnp.sum(state * cot_s)

    jgrads_chunked = jax.grad(jloss, argnums=1)(*map(jnp.asarray, arrays))
    assert np.isnan(np.asarray(jgrads_chunked)).any()
    targs = torch_args(arrays, requires_grad=True)
    y, state = ssm.ssd_scan_ref(*targs, chunk=chunk, return_final_state=True)
    (torch.sum(y * torch.from_numpy(cot_y))
     + torch.sum(state * torch.from_numpy(cot_s))).backward()
    _check_grads(targs, jgrads)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_kernel_function_backward_matches_jax_grad(case):
    """The kernel's autograd.Function, with the plain forward injected in
    place of the kernel: its backward (through the port's chunked scan)
    against jax.grad of the sequential recurrence, y and final state."""
    arrays, chunk, cot_y, cot_s, jgrads = sequential_grads(case)
    targs = torch_args(arrays, requires_grad=True)
    y, state = ops.SSDScan.apply(ops._plain_forward, *targs, chunk, True)
    (torch.sum(y * torch.from_numpy(cot_y))
     + torch.sum(state * torch.from_numpy(cot_s))).backward()
    _check_grads(targs, jgrads)


# ---------------------------------------------------------------------------
# The kernel's decomposition (csrc/ssd_scan.cu), mirrored in plain torch
# ---------------------------------------------------------------------------

def decomposed_scan(x, dt, A, B, C, chunk, mm=torch.matmul):
    """The kernel's algorithm: the chunk cumsum of dt * A in float64;
    C.B^T once per (batch, chunk, group); each chunk's own state
    B^T diag(dt exp(cs_L - cs)) x; the states across chunks; y = scores
    . x dt + exp(cs) C . state_in. Returns (y in x's dtype, final state
    (b, h, n, p)); `mm` takes every matrix product."""
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    c = -(-s // chunk)
    pad = c * chunk - s

    def chunks(t):   # (b, s, ...) -> (b, c, L, ...), dt = 0 steps past s
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(b, c, chunk, *t.shape[2:])

    xc, dtc, Bc, Cc = (chunks(t) for t in (x, dt, B, C))
    dth = dtc.permute(0, 1, 3, 2)                           # (b, c, h, L)
    cs = (dth * A.float()[:, None]).double().cumsum(-1)
    rep = h // g
    cb = mm(Cc.transpose(2, 3), Bc.permute(0, 1, 3, 4, 2))  # (b, c, g, L, L)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    seg = torch.where(causal, cs[..., :, None] - cs[..., None, :],
                      -torch.inf)
    scores = cb.repeat_interleave(rep, dim=2) * torch.exp(seg.float())
    xh = xc.permute(0, 1, 3, 2, 4)                          # (b, c, h, L, p)
    Bh, Ch = (t.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
              for t in (Bc, Cc))                            # (b, c, h, L, n)
    w = dth * torch.exp((cs[..., -1:] - cs).float())
    own = mm(Bh.transpose(-1, -2), xh * w[..., None])       # (b, c, h, n, p)
    run, state_in = torch.zeros_like(own[:, 0]), []
    for j in range(c):
        state_in.append(run)
        run = torch.exp(cs[:, j, :, -1].float())[..., None, None] * run \
            + own[:, j]
    y = (mm(scores, xh * dth[..., None])
         + mm(Ch * torch.exp(cs.float())[..., None],
              torch.stack(state_in, dim=1)))
    y = y.permute(0, 1, 3, 2, 4).reshape(b, c * chunk, h, p)[:, :s]
    return y.to(x.dtype), run


# (b, s, h, p, g, n, chunk): 5 chunks, the last ragged (8 of 16 steps)
DECOMP_SHAPE = (2, 72, 4, 32, 2, 16, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_decomposition_matches_jax(g, dtype):
    """The mirror against the JAX package: y and the final state to 1e-4
    (float32 x, the sequential `ssd_ref`) or to 0.05 (bfloat16 x, the
    Pallas kernel in interpret mode, as the wrapper's test)."""
    b, s, h, p, _, n, chunk = DECOMP_SHAPE
    x, dt, A, B, C = scan_inputs(b, s, h, p, g, n, seed=8)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    y, state = decomposed_scan(tx, *torch_args((dt, A, B, C)), chunk)
    assert y.dtype == tx.dtype and state.shape == (b, h, n, p)
    if dtype == "float32":
        jy, jstate = jax_sequential_scan(*map(jnp.asarray, (x, dt, A, B, C)))
        atol = 1e-4
    else:
        jy, jstate = jops.ssd_scan(
            jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (dt, A, B, C)),
            chunk=chunk, return_final_state=True, interpret=True)
        atol = 0.05
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=0,
                               atol=atol)


def test_tf32_rounding_by_bits():
    v = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -20, 3.0])
    np.testing.assert_array_equal(
        tf32(v).numpy(), np.float32([1 + 2 ** -10, 1 + 2 ** -9,
                                     -(1 + 2 ** -10), 1.0, 3.0]))
    np.testing.assert_array_equal(
        tf32(v, truncate=True).numpy(),
        np.float32([1.0, 1 + 2 ** -10, -1.0, 1.0, 3.0]))


@pytest.mark.parametrize("decay", ["chip", "strong"])
def test_three_tf32_passes_hold_float32_accuracy(decay):
    """The mirror's products from TF32 operands at the chip's shape of a
    head (n = 128, chunk 128, B and C scaled by (8 / n) ** 0.5 as
    chip_smoke.py draws them, |y| ~ 10): three passes stay within 1e-4
    of float32 products, one pass does not. "strong": A = -8, a decay
    of e^-8 and more a step."""
    b, s, h, p, g, n, chunk = 1, 256, 2, 32, 1, 128, 128
    x, dt, A, B, C = scan_inputs(b, s, h, p, g, n, seed=9,
                                 A=-8.0 if decay == "strong" else None)
    args = torch_args((x, dt, A, B * (8 / n) ** 0.5, C * (8 / n) ** 0.5))
    y, state = decomposed_scan(*args, chunk)
    assert float(y.abs().max()) > 5
    for passes, within in ((3, True), (1, False)):
        y_tc, state_tc = decomposed_scan(*args, chunk,
                                         mm=matmul_tf32(passes))
        err = max(float((y_tc - y).abs().max()),
                  float((state_tc - state).abs().max()))
        assert (err <= 1e-4) == within, (passes, err)
