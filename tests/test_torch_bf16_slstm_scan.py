"""K6's plain versions at the reference's bfloat16 dtype contract: the
port's ``slstm_scan`` (on the CPU, cell_scan's plain forward and reverse)
with bfloat16 xg and R and float32 h0 / c0 / n0 / m0, against the
reference's ``slstm_scan(impl="pallas")`` in interpret mode on the same
bfloat16 inputs, in every mode of tests/test_torch_slstm_scan.py (RH
structured / dense / off, per-step / FIXED, ragged, fresh / handoff).

Outputs: hs and the final (h, c, n, m), and the gradients of all six inputs
for that file's loss. Every output and cotangent must carry the
reference's dtype (hs and states float32, dxg and dR bfloat16, dh0 and the
state cotangents float32).

Tolerance: ``ref32`` is the reference's float32 run on the same
bfloat16-rounded inputs. For each output and gradient, the port's max-abs
distance from ref32 must be at most 2 x the reference's bfloat16 run's
distance from ref32, plus 1e-3 x max(1, max |ref32|).
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import to_numpy, to_tensor
from repro_torch.kernels import slstm_scan as t_ss

torch.set_num_threads(1)

NAMES = ("xg", "R", "h0", "c0", "n0", "m0")
OUTS = ("hs", "h_fin", "c_fin", "n_fin", "m_fin") + tuple(f"d{n}" for n in NAMES)
T, B, NH, DH = 5, 3, 3, 16

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops  # noqa: E402

from test_torch_slstm_scan import CASES, _inputs, _loss  # noqa: E402


def _bf16_inputs(d):
    """xg and R rounded to bfloat16 (numpy, ml_dtypes); the states float32."""
    return {k: (np.asarray(jnp.asarray(v, jnp.bfloat16)) if k in ("xg", "R") else v)
            for k, v in d.items()}


def _reference(d, kw):
    def loss(*a):
        ys, (hf, (cf, nf, mf)) = ops.slstm_scan(*a, impl="pallas", **kw)
        ys = ys.astype(jnp.float32)
        return _loss(ys, hf, cf, nf, mf), (ys, hf, cf, nf, mf)
    (_, outs), grads = jax.value_and_grad(loss, argnums=tuple(range(6)),
                                          has_aux=True)(*(jnp.asarray(d[k]) for k in NAMES))
    return [np.asarray(x) for x in (*outs, *grads)]


def _port(d, kw):
    ins = [to_tensor(d[k]).requires_grad_(True) for k in NAMES]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    hs, (hf, (cf, nf, mf)) = t_ss.slstm_scan(*ins, impl="pallas", **tkw)
    grads = torch.autograd.grad(_loss(hs.float(), hf, cf, nf, mf), ins)
    return [hs, hf, cf, nf, mf, *grads]


def _assert_bf16_rule(got, ref16, ref32, names):
    """Port vs ref32 within 2 x the reference's bfloat16 distance + 1e-3 x
    max(1, max|ref32|), leaf by leaf (max-abs)."""
    for g, r16, r32, nm in zip(got, ref16, ref32, names):
        g = np.asarray(g, np.float64)
        r16, r32 = np.asarray(r16, np.float64), np.asarray(r32, np.float64)
        assert np.all(np.isfinite(g)), nm
        dp = np.abs(g - r32).max()
        dr = np.abs(r16 - r32).max()
        lim = 2 * dr + 1e-3 * max(1.0, np.abs(r32).max())
        assert dp <= lim, f"{nm}: port {dp:.3e} from ref32, limit {lim:.3e} (ref bf16 {dr:.3e})"


@pytest.mark.parametrize("mode,fixed,ragged,fresh", CASES)
def test_bf16_matches_reference(mode, fixed, ragged, fresh):
    d, kw = _inputs(mode, fixed, ragged, fresh,
                    mask_heads=NH if (mode, fixed) == ("dense", True) else 1)
    d16 = _bf16_inputs(d)
    d32 = {k: np.asarray(v, np.float32) for k, v in d16.items()}
    ref16, ref32 = _reference(d16, kw), _reference(d32, kw)
    got = _port(d16, kw)
    want_dt = [str(r.dtype) for r in ref16]
    assert [str(g.dtype)[6:] for g in got] == want_dt
    assert want_dt[5:7] == ["bfloat16", "bfloat16"]          # dxg, dR
    _assert_bf16_rule([to_numpy(g) for g in got], ref16, ref32, OUTS)


def test_bf16_plain_rounds_where_the_reference_does():
    """The gates residual is stored in xg's dtype and the backward reads the
    rounded values; dR sums the unrounded float32 dgates (so it differs from
    a product of the rounded dxg)."""
    from repro_torch.kernels import cell_scan as t_cs
    d, kw = _inputs("off", False, False, True, seed=3)
    d16 = _bf16_inputs(d)
    x = {k: to_tensor(v) for k, v in d16.items()}
    hs, gates, sts = t_cs.plain_fwd(t_ss.SLSTM_CELL, x["xg"], x["R"], x["h0"],
                                    (x["c0"], x["n0"], x["m0"]), None, None, None, 1.0)
    assert gates.dtype == torch.bfloat16 and hs.dtype == torch.float32
    assert all(s.dtype == torch.float32 for s in sts)
    dy = torch.ones_like(hs)
    dst = tuple(torch.zeros_like(s[-1]) for s in sts)
    dgx, du, dh0, _ = t_cs.plain_bwd(t_ss.SLSTM_CELL, dy, dst, gates, sts,
                                     (x["c0"], x["n0"], x["m0"]), hs, x["h0"],
                                     x["R"], None, None, None, 1.0)
    assert dgx.dtype == torch.float32 and du.dtype == torch.float32
    hp = torch.cat([x["h0"][None], hs[:-1]])
    from_rounded = torch.einsum("tbhu,tbhc->huc", hp, dgx.bfloat16().float())
    assert torch.allclose(du, torch.einsum("tbhu,tbhc->huc", hp, dgx), atol=1e-5)
    assert not torch.equal(du, from_rounded)
