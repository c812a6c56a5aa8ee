"""pixtral-12b (embeddings in) and whisper-base (encoder-decoder) in the
port against the JAX reference: the features, loss and every gradient
with ``attn_impl`` "xla" and "flash", the encoder's dropout sites,
``remat="dots"``, one bfloat16 step against float64, the sinusoidal rows,
whisper's ``encode``, cross-K/V ``prefill`` and decode steps, pixtral's
embeddings prefill and decode, the trainer's batches, the train CLI and the
serve CLI. The checks, their inputs and their tolerances are
tests/test_torch_transformer_configs.py's (see its docstring), which
holds the dense configs; this file holds these two, so that the test
workers take the configs in parallel.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.distributed.sharding import strip  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import tree_map  # noqa: E402
from repro_torch.testing import to_numpy_tree, to_torch  # noqa: E402
from test_torch_transformer_configs import B, _cfgs, _reference  # noqa: E402
from test_torch_transformer_configs import (  # noqa: E402
    test_bf16_step_against_float64 as _bf16_step,
    test_features_match_reference as _features,
    test_loss_and_grads_match_reference as _loss_and_grads,
    test_remat_dots_matches_full_and_reference as _remat_dots,
    test_train_cli_runs_on_cpu as _train_cli,
    test_trainer_batches_equal_reference as _trainer_batches)

torch.set_num_threads(1)

ARCHS = ("pixtral-12b", "whisper-base")
CASES = [(a, i) for a in ARCHS for i in ("xla", "flash")]


@pytest.mark.parametrize("arch,attn_impl", CASES)
def test_features_match_reference(arch, attn_impl):
    _features(arch, attn_impl)


@pytest.mark.parametrize("arch,attn_impl", CASES)
def test_loss_and_grads_match_reference(arch, attn_impl):
    _loss_and_grads(arch, attn_impl)


def test_injected_sites_cover_the_encoder():
    ref = _reference("whisper-base")
    assert set(ref["inj"]) == {"attn/nr", "mlp/nr", "enc/attn/nr", "enc/mlp/nr"}
    assert ref["inj"]["enc/attn/nr"].shape == (2, 6)       # 2 layers, 6 of 8 blocks


def test_unread_leaves_only_where_declared():
    """whisper's loss reads neither ``enc_blocks`` nor ``enc_ln_f``: with
    them declared (``unused_in_loss``, as the trainer passes them) their
    gradients are zeros; with nothing declared, or with only one of them,
    ``value_and_grad`` raises instead of training on zeros."""
    from repro_torch.optim import tree_leaves, value_and_grad
    ref = _reference("whisper-base")
    t_cfg = _cfgs("whisper-base")[1]
    assert t_tf.unused_in_loss(t_cfg) == ("enc_blocks", "enc_ln_f")
    assert t_tf.unused_in_loss(_cfgs("gemma-2b")[1]) == ()
    lfn = lambda p, b, **kw: t_tf.loss_fn(p, b, t_cfg, **kw)
    args = (from_reference(ref["params"]), to_torch(ref["batch"]))
    _, grads = value_and_grad(lfn, t_tf.unused_in_loss(t_cfg))(*args, seed=None)
    for k in ("enc_blocks", "enc_ln_f"):
        assert all(not g.any() for g in tree_leaves(grads[k])), k
    assert any(g.any() for g in tree_leaves(grads["blocks"]))
    for unused in ((), ("enc_blocks",)):
        with pytest.raises(RuntimeError):
            value_and_grad(lfn, unused)(*args, seed=None)


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_remat_dots_matches_full_and_reference(arch):
    _remat_dots(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_against_float64(arch):
    _bf16_step(arch)


# ---------------------------------------------------------------------------
# serving: whisper's encoder, cross K/V and decode; pixtral's embeddings
# ---------------------------------------------------------------------------


def test_sinusoidal_table_matches_reference():
    got = t_tf.sinusoidal_table(40, 64).numpy()
    np.testing.assert_allclose(got, np.asarray(r_tf.sinusoidal_table(40, 64)),
                               rtol=0, atol=1e-6)


def test_sinusoidal_rows_match_the_reference_table_at_decode_positions():
    """whisper-base's rows 0 .. 447 (its published text context, the
    positions its decode reaches), each built alone as ``decode_step`` builds
    it, against the reference's table: float32 sin / cos of pos * div,
    where div's exp may differ by an ulp between the two libraries and pos
    multiplies that, so within 1e-4 (the largest difference is printed)."""
    want = np.asarray(r_tf.sinusoidal_table(448, 512))
    rows = torch.stack([t_tf.sinusoidal(torch.tensor(p), 512) for p in range(448)])
    diff = float(np.abs(rows.numpy() - want).max())
    print(f"largest sinusoidal row difference over positions < 448: {diff:.3e}")
    assert diff <= 1e-4
    np.testing.assert_array_equal(rows.numpy(), t_tf.sinusoidal_table(448, 512).numpy())


def _serve_ref(arch, n_dec=8, **kw):
    """The reference's prefill (and whisper's encoder) and ``n_dec``
    teacher-forced decode steps on a seeded prompt; returns the inputs,
    params and every output as numpy."""
    r_cfg, _ = _cfgs(arch, **kw)
    params = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(5)
    P = 7
    if r_cfg.embeds_in:
        prompt = rng.standard_normal((B, P, r_cfg.d_model)).astype(np.float32)
        steps = rng.standard_normal((B, n_dec, 1, r_cfg.d_model)).astype(np.float32)
    else:
        prompt = rng.integers(3, r_cfg.vocab, (B, P)).astype(np.int32)
        steps = rng.integers(3, r_cfg.vocab, (B, n_dec, 1)).astype(np.int32)
    frames = (rng.standard_normal((B, r_cfg.enc_seq, r_cfg.d_model)) * 0.02
              ).astype(np.float32)
    cache = r_tf.init_cache(r_cfg, B, P + n_dec)
    memory = (r_tf.encode(jp, jnp.asarray(frames), r_cfg)
              if r_cfg.is_encoder_decoder else None)
    feats, cache = r_tf.prefill(jp, jnp.asarray(prompt), r_cfg, cache, memory=memory)
    out = {"prefill": np.asarray(feats), "cache": to_numpy_tree(cache)}
    if memory is not None:
        out["memory"] = np.asarray(memory)
    logits = []
    for t in range(n_dec):
        lg, cache = r_tf.decode_step(jp, r_cfg, cache, jnp.asarray(steps[:, t]), P + t)
        logits.append(np.asarray(lg))
    out["logits"] = np.stack(logits)
    return dict(params=params, prompt=prompt, steps=steps, frames=frames, out=out)


def _serve_port(arch, ref, **kw):
    _, t_cfg = _cfgs(arch, **kw)
    params = from_reference(ref["params"])
    n_dec, P = ref["steps"].shape[1], ref["prompt"].shape[1]
    cache = t_tf.init_cache(t_cfg, B, P + n_dec)
    bufs = {k: v.data_ptr() for k, v in cache.items()}
    batch = {"tokens": torch.from_numpy(ref["prompt"]),
             "frames": torch.from_numpy(ref["frames"])}
    if t_cfg.embeds_in:
        batch = {"embeds": batch["tokens"]}
    with torch.no_grad():
        out = {}
        if t_cfg.is_encoder_decoder:
            out["memory"] = t_tf.encode(params, batch["frames"], t_cfg).numpy()
        feats, cache2 = t_adapters.prefill_fn(t_configs.get_arch(arch))(
            params, batch, t_cfg, cache)
        assert cache2 is cache and {k: v.data_ptr() for k, v in cache.items()} == bufs
        out["prefill"] = feats.numpy()
        out["cache"] = to_reference(tree_map(torch.clone, cache))
        logits = []
        for t in range(n_dec):
            lg, _ = t_tf.decode_step(params, t_cfg, cache,
                                     torch.from_numpy(ref["steps"][:, t]),
                                     torch.tensor(P + t))
            logits.append(lg.numpy())
    out["logits"] = np.stack(logits)
    return out


@pytest.mark.parametrize("arch,attn_impl", [("whisper-base", "xla"),
                                            ("whisper-base", "flash"),
                                            ("pixtral-12b", "xla")])
def test_prefill_and_decode_match_reference(arch, attn_impl):
    """whisper: ``encode``, the prefill's features and its cross K/V
    written in place into the cache, and the logits of 8 decode steps over
    them; pixtral: the same from (B, S, D) embeddings. Features and logits
    and the caches rtol 1e-5, atol 1e-5 x max(1, |ref|)."""
    ref = _serve_ref(arch, attn_impl=attn_impl)
    got = _serve_port(arch, ref, attn_impl=attn_impl)
    want = ref["out"]
    assert set(got["cache"]) == set(want["cache"])
    for name in ("memory", "prefill", "logits"):
        if name in want:
            w = want[name]
            np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=name)
    for k, w in want["cache"].items():
        np.testing.assert_allclose(got["cache"][k], w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=k)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_batches_equal_reference(arch):
    _trainer_batches(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_cpu(arch):
    _train_cli(arch)


SERVE = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
         "--gen", "8", "--chunk", "4"]


def test_serve_cli_whisper_tokens_equal_reference(monkeypatch):
    """The serve CLI of whisper-base (smoke) on the reference's parameters:
    its prompt, frames and prefill batch as the reference's CLI draws them,
    and greedy tokens equal to the reference engine's; the python loop's
    equal the chunked loop's."""
    from repro.serving import DecodeEngine as RDecodeEngine
    r_cfg = r_configs.get_arch("whisper-base").smoke()
    params = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(3, r_cfg.vocab, size=(2, 6)), jnp.int32)
    frames = jnp.asarray(rng.standard_normal((2, r_cfg.enc_seq, r_cfg.d_model)) * 0.02,
                         r_cfg.compute_dtype)
    # the reference CLI's engine, without its host mesh (whose sharding
    # constraint this JAX refuses, as tests/test_serving.py's host-mesh case)
    eng = RDecodeEngine(spec=r_configs.get_arch("whisper-base"), cfg=r_cfg,
                        params=jax.tree.map(jnp.asarray, params), max_seq=14,
                        batch=2, chunk=4)
    eng.prefill({"tokens": prompt[:, :-1], "frames": frames})
    want = np.asarray(eng.generate(prompt[:, -1:], 8, seed=0, start_pos=5))
    monkeypatch.setattr(t_adapters, "init_params",
                        lambda kind, gen, cfg, device="cpu": from_reference(params))
    got = t_serve.run(["--arch", "whisper-base", *SERVE])["tokens"]
    np.testing.assert_array_equal(got, want)
    py = t_serve.run(["--arch", "whisper-base", *SERVE, "--loop", "python"])["tokens"]
    np.testing.assert_array_equal(py, want)


def test_serve_cli_pixtral_prefills_and_stops(capsys):
    res = t_serve.run(["--arch", "pixtral-12b", *SERVE])
    assert res["tokens"] is None
    assert "embeds-in archs decode from embeddings" in capsys.readouterr().out
