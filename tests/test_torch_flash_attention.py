"""The port's flash attention (kernels/flash_attention.py) against the JAX
reference's Pallas kernel, which runs here in interpret mode as
``tests/test_flash.py`` runs it.

The cases are ``tests/test_flash.py``'s (forward causal and not, GQA, MQA,
uneven blocks, window, bf16, grads, windowed grads) on the same numpy
inputs for both sides; on CPU tensors the port runs its plain version
(masked float32 scores and a softmax, differentiated by autograd).
Tolerances are the reference test's: 2e-5 forward, 5e-4 grads, 3e-2 bf16.
K10's and K11's plain versions (explicit formulas from lse and delta) are
held to autograd of the plain forward at 1e-5 (float32, the same products
in another order). The ``cuda``-marked cases hold the kernels K9-K11 to the
plain versions on the card (1e-4 x max(1, |ref|) float32; 3e-2 bf16), K10
and K11 also to a float64 backward (1e-5 x max(1, |ref|)) and to their own
bits on a second launch, and skip here.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as r_flash  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.testing import require_cuda  # noqa: E402

torch.set_num_threads(1)


def _inputs(B, Sq, H, Hkv, d, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, d)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, d)).astype(np.float32))


def _port(q, k, v, causal, window, dtype=torch.float32):
    return fa.flash_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                              causal, window)


@pytest.mark.parametrize("B,S,H,Hkv,d,bq,bk", [
    (1, 32, 2, 2, 8, 8, 8),
    (2, 64, 4, 2, 16, 16, 16),      # GQA
    (1, 48, 4, 1, 8, 16, 8),        # MQA, uneven blocks
    (2, 32, 2, 2, 8, 32, 32),       # single block
])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference(B, S, H, Hkv, d, bq, bk, causal):
    q, k, v = _inputs(B, S, H, Hkv, d)
    ref = r_flash(*(jnp.asarray(x) for x in (q, k, v)), causal, None, bq, bk, True)
    np.testing.assert_allclose(_port(q, k, v, causal, None).numpy(),
                               np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("window", [8, 16])
def test_window_matches_reference(window):
    q, k, v = _inputs(1, 64, 2, 2, 8)
    ref = r_flash(*(jnp.asarray(x) for x in (q, k, v)), True, window, 16, 16, True)
    np.testing.assert_allclose(_port(q, k, v, True, window).numpy(),
                               np.asarray(ref), atol=2e-5)


def test_bf16_matches_reference():
    q, k, v = _inputs(2, 32, 4, 2, 16)
    ref = r_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True, None,
                  8, 8, True)
    got = _port(q, k, v, True, None, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2)


def _grads(q, k, v, causal, window, bq):
    """(reference grads, port grads) of sum(o ** 2)."""
    gr = jax.grad(lambda *a: (r_flash(*a, causal, window, bq, bq, True) ** 2).sum(),
                  argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    gt = torch.autograd.grad((fa.flash_attention(*ts, causal, window) ** 2).sum(), ts)
    return gr, gt


@pytest.mark.parametrize("B,S,H,Hkv,d", [
    (1, 32, 2, 2, 8),
    (2, 32, 4, 2, 8),               # GQA grads sum over the group
])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_reference(B, S, H, Hkv, d, causal):
    gr, gt = _grads(*_inputs(B, S, H, Hkv, d), causal, None, 8)
    for a, b, name in zip(gr, gt, "qkv"):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4,
                                   err_msg=f"d{name} mismatch")


def test_grads_window_match_reference():
    gr, gt = _grads(*_inputs(1, 32, 2, 2, 8), True, 8, 8)
    for a, b in zip(gr, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4)


@pytest.mark.parametrize("Sq,Sk,H,Hkv,causal,window", [
    (24, 24, 4, 2, True, None),
    (24, 24, 4, 1, False, None),
    (20, 36, 6, 2, True, 7),        # Sq < Sk, window, G = 3
    (36, 20, 2, 2, True, None),     # Sq > Sk
])
def test_plain_backward_passes_equal_autograd(Sq, Sk, H, Hkv, causal, window):
    """flash_dq_plain / flash_dkv_plain (K10 / K11's plain versions, from lse
    and delta = rowsum(do * o)) equal autograd of the plain forward."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(2, Sq, H, Hkv, 16, Sk=Sk, seed=1))
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, Sq, H, 16)).astype(np.float32))
    o, lse = fa.attention_plain(q, k, v, causal, window)
    want = torch.autograd.grad(o, (q, k, v), do)
    args = (q.detach(), k.detach(), v.detach(), do, lse.detach(),
            fa.flash_delta(o.detach(), do), causal, window)
    got = (fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args))
    for g, w, name in zip(got, want, "qkv"):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=f"d{name}")


def test_plain_lse_is_logsumexp_of_masked_scores():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 1, 8))
    _, lse = fa.attention_plain(q, k, v, True, 4)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(-1, -1, 2, -1)) * 8 ** -0.5
    pos = torch.arange(16)
    vis = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < 4)
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """No kernel is built or launched for CPU tensors; the CUDA launchers
    raise on them."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel library was loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    before = dict(fa.LAUNCHES)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(1, 16, 4, 2, 16))
    o = fa.flash_attention(q, k, v)
    o.sum().backward()
    assert fa.LAUNCHES == before
    torch.testing.assert_close(o, fa.attention_plain(q, k, v)[0])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q.detach(), k.detach(), v.detach())


@pytest.mark.parametrize("window,Sq,Sk", [(0, 8, 8), (4, 16, 8)])
def test_rows_without_keys_are_refused(window, Sq, Sk):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, Sq, 2, 2, 8, Sk=Sk))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, True, window)


def test_bq_bk_do_not_change_the_result():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 32, 2, 2, 8))
    torch.testing.assert_close(fa.flash_attention(q, k, v, True, None, 8, 16),
                               fa.flash_attention(q, k, v, True, None, 512, 512),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the kernels on the card (skip without one)
# ---------------------------------------------------------------------------

CUDA_CASES = [
    # B, Sq, Sk, Hq, Hkv, d, causal, window, dtype (float32: every head dim)
    (2, 100, 100, 4, 2, 64, True, None, torch.float32),
    (1, 80, 144, 4, 1, 128, True, None, torch.float32),
    (1, 144, 80, 8, 2, 32, False, None, torch.float32),
    (1, 130, 130, 4, 2, 16, True, 24, torch.float32),
    (1, 96, 96, 2, 2, 256, True, None, torch.float32),
    (1, 150, 150, 6, 2, 64, True, 48, torch.float32),      # G = 3 (mixtral's), window
    (2, 200, 136, 6, 2, 256, False, None, torch.float32),  # Sq != Sk, neither a tile multiple
    (1, 170, 90, 4, 2, 128, True, None, torch.float32),
    (2, 64, 64, 4, 2, 128, True, None, torch.bfloat16),
    (1, 100, 100, 6, 2, 128, True, 40, torch.bfloat16),
]


def _close(got, want, dtype):
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    scale = max(1.0, float(want.detach().float().abs().max()))
    torch.testing.assert_close(got.detach().float(), want.detach().float(), rtol=0,
                               atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window,dtype", CUDA_CASES)
def test_cuda_kernels_match_plain(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype):
    dev = require_cuda()
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(*s, generator=g).to(dev, dtype) for s in (
        (B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d), (B, Sq, Hq, d)))
    o_p, lse_p = fa.attention_plain(q, k, v, causal, window)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
    _close(o, o_p, dtype)
    _close(lse, lse_p, dtype)
    args = (q, k, v, do, lse_p, fa.flash_delta(o_p, do), causal, window)
    _close(fa.flash_dq_cuda(*args), fa.flash_dq_plain(*args), dtype)
    for got, want in zip(fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)):
        _close(got, want, dtype)


@pytest.mark.cuda
def test_cuda_backward_keeps_float32_accuracy():
    """K10 and K11 (split-precision TF32 on the tensor cores) against a
    float64 backward within 1e-5 x max(1, |ref|), which single-pass TF32
    (~2^-11 a product) misses. The kernels get lse and delta from the
    float64 forward, rounded to float32."""
    dev = require_cuda()
    g = torch.Generator().manual_seed(3)
    B, S, Hq, Hkv, d = 1, 1024, 4, 2, 128
    q, k, v, do = (torch.randn(*s, generator=g).to(dev) for s in (
        (B, S, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d), (B, S, Hq, d)))
    groups = [fa.backward_float64(q, k, v, do, True, None, 0, hk) for hk in range(Hkv)]
    lse = torch.cat([grp[0] for grp in groups])[None].float().contiguous()
    delta = torch.cat([grp[1] for grp in groups])[None].float().contiguous()
    args = (q, k, v, do, lse, delta, True, None)
    got = (fa.flash_dq_cuda(*args)[0], *(x[0] for x in fa.flash_dkv_cuda(*args)))
    want = (torch.cat([grp[2] for grp in groups], 1), torch.stack([grp[3] for grp in groups], 1),
            torch.stack([grp[4] for grp in groups], 1))
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        scale = max(1.0, float(w.abs().max()))
        err = float((x.double() - w).abs().max())
        assert err <= 1e-5 * scale, f"{name}: {err:.3e} > 1e-5 x {scale:.3g}"


@pytest.mark.cuda
def test_cuda_backward_is_deterministic():
    """Two launches of K10 and K11 give the same bits (no atomics)."""
    dev = require_cuda()
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(*s, generator=g).to(dev) for s in (
        (1, 300, 6, 128), (1, 300, 2, 128), (1, 300, 2, 128), (1, 300, 6, 128)))
    o, lse = fa.attention_plain(q, k, v, True, None)
    args = (q, k, v, do, lse, fa.flash_delta(o, do), True, None)
    first = (fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
    second = (fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_kernels_read_strided_views():
    """q, k, v and do as head slices of wider tensors (no copy is made):
    the kernels follow the batch / sequence / head strides."""
    dev = require_cuda()
    g = torch.Generator().manual_seed(2)
    wide = lambda B, S, H, d: torch.randn(B, S, H + 3, d, generator=g).to(dev)[:, :, 1:H + 1]
    q, do = wide(2, 70, 4, 64), wide(2, 70, 4, 64)
    k, v = wide(2, 70, 2, 64), wide(2, 70, 2, 64)
    assert not q.is_contiguous() and fa._prep(q).data_ptr() == q.data_ptr()
    o_p, lse_p = fa.attention_plain(q, k, v, True, None)
    o, lse = fa.flash_fwd_cuda(q, k, v, True, None)
    _close(o, o_p, torch.float32)
    _close(lse, lse_p, torch.float32)
    args = (q, k, v, do, lse_p, fa.flash_delta(o_p, do), True, None)
    _close(fa.flash_dq_cuda(*args), fa.flash_dq_plain(*args), torch.float32)
    for got, want in zip(fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)):
        _close(got, want, torch.float32)


@pytest.mark.cuda
def test_cuda_autograd_function_matches_plain_autograd():
    """flash_attention on CUDA tensors (K9, then K10/K11 in the backward)
    against autograd of the plain version, with the launch counts."""
    dev = require_cuda()
    g = torch.Generator().manual_seed(1)
    shapes = ((1, 128, 8, 64), (1, 128, 2, 64), (1, 128, 2, 64))
    ins = [torch.randn(*s, generator=g).to(dev).requires_grad_(True) for s in shapes]
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(*ins, True, None)
    got = torch.autograd.grad((o ** 2).sum(), ins)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    o_p = fa.attention_plain(*ins, True, None)[0]
    want = torch.autograd.grad((o_p ** 2).sum(), ins)
    _close(o, o_p, torch.float32)
    for a, b in zip(got, want):
        _close(a, b, torch.float32)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_unsupported_inputs():
    dev = require_cuda()
    q = torch.randn(1, 8, 2, 24, device=dev)      # head_dim 24
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q.float(), q.float().cpu(), q.float())
