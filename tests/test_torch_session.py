"""The port's language-model path (models + serve/session.py) against the
JAX package's, for each of the 8 smoke configs of the attention families.

The same weights (``numpy_params`` at the Spec scales, the zero-initialized
norm scales and biases drawn at 0.1 so that they take part) and the same
tokens, made with numpy, go through both packages on the CPU: the forward
logits, prefill (logits and caches) then two decode steps from those
caches (logits and caches), and ``ServeSession.generate``. The JAX side
runs once per config and dtype (jitted) and is shared by the tests. The
port's attention takes its plain version here (CPU tensors).

Tolerances: f32 ``F32`` (atol 1e-5 plus rtol 1e-5): the same f32
arithmetic in another order of summation. bf16 ``BF16`` (2e-2), the
reference's own (tests/test_system.py). Generated tokens in f32 must be
equal. bf16 caches are held to 2e-2 of their largest value besides (the
keys run to 3.7 after the qk-norm, where a bf16 step is 0.016, while the
logits stay under 1). In bf16 a one-step difference upstream of a router can send a
token to another expert, a jump no tolerance bounds (mixtral's smoke
config has a token whose second and third router probabilities lie 8.6e-6
apart), so the MoE configs are held whole in f32 and, in bf16, module by
module (tests/test_torch_models.py::test_moe_matches_jax). The RWKV-6
and RG-LRU configs wait for the next slice and raise.
Mirrors tests/test_system.py: prefill/decode, decode against the sliced
forward, the session and the int8 KV cache.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS
from repro.models import build_model as jbuild
from repro.serve.engine import ServeSession as JSession
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.models import build_model
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.models.transformer import RECURRENT_SLICE
from repro_torch.serve.engine import ServeSession
from test_torch_models import BF16, F32, _close, _np

NAMES = sorted(n for n, c in SMOKE_ARCHS.items()
               if c.family in ("dense", "vlm", "audio", "moe"))
B, S, STEPS = 2, 32, 4


def _close_caches(got, want, tol):
    """Each cache leaf within ``tol``, its atol scaled by the leaf's
    largest value where that is above 1 (see the module docstring)."""
    def one(g, w):
        w = _np(w)
        scale = max(1.0, float(np.abs(w).max())) if tol is BF16 else 1.0
        _close(g, w, dict(tol, atol=tol["atol"] * scale))
    jax.tree_util.tree_map(one, got, want)


def _weights(cfg, seed=0):
    """``numpy_params`` with every all-zero leaf drawn at 0.1 instead."""
    rng = np.random.default_rng(seed + 1)

    def fill(a):
        if isinstance(a, dict):
            return {k: fill(a[k]) for k in sorted(a)}
        if a.any():
            return a
        return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
    return fill(numpy_params(cfg, seed))


def _batches(cfg, seed=2):
    """(prompt batch, first decode batch, second decode batch) as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        emb = rng.standard_normal((B, S + 2, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        return ({"embeds": emb[:, :S], "positions": pos},
                {"embeds": emb[:, S:S + 1]}, {"embeds": emb[:, S + 1:]})
    shape = (B, cfg.n_codebooks, S + 2) if cfg.n_codebooks else (B, S + 2)
    tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return ({"tokens": tok[..., :S]}, {"tokens": tok[..., S:S + 1]},
            {"tokens": tok[..., S + 1:]})


def _tree(fn, tree):
    return jax.tree_util.tree_map(fn, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, dtype: str) -> dict:
    """The JAX package's outputs for one smoke config: forward logits,
    prefill caches, two decode steps (logits, caches), as numpy."""
    cfg = SMOKE_ARCHS[name].replace(dtype=dtype)
    model = jbuild(cfg)
    params = _tree(jnp.asarray, _weights(cfg))
    prompt, d1, d2 = _batches(cfg)
    logits, caches = jax.jit(model.prefill)(params, _tree(jnp.asarray, prompt))
    out = {"logits": _np(logits), "caches": _tree(_np, caches)}
    decode = jax.jit(model.decode)
    for i, db in enumerate((d1, d2)):
        dl, caches = decode(params, _tree(jnp.asarray, db), caches,
                            jnp.asarray(S + i, jnp.int32))
        out[f"decode{i}"] = (_np(dl), _tree(_np, caches))
    return out


def _port(name: str, dtype: str, attention: str = "cuda"):
    cfg = T_SMOKE[name].replace(dtype=dtype)
    model = build_model(cfg, attention=attention)
    params = params_from_numpy(_weights(cfg), "cpu")
    return cfg, model, params


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("name,dtype", [
    (n, dt) for n in NAMES for dt in ("float32", "bfloat16")
    if dt == "float32" or SMOKE_ARCHS[n].family != "moe"])
def test_prefill_then_decode_matches_jax(name, dtype):
    """forward, prefill (logits and the caches, int8 too where the config
    says so) and two decode steps from the prefill's caches, against the
    JAX package's. The second step writes slot S + 1 mod L: the ring has
    wrapped on every layer."""
    tol = F32 if dtype == "float32" else BF16
    want = _jax_run(name, dtype)
    cfg, model, params = _port(name, dtype)
    prompt, d1, d2 = _batches(cfg)
    with torch.inference_mode():
        logits, _, none = model.forward(params, _torch_batch(prompt))
        assert none is None
        _close(logits, want["logits"], tol)
        logits, caches = model.prefill(params, _torch_batch(prompt))
        _close(logits, want["logits"], tol)
        last, _ = model.prefill(params, _torch_batch(prompt), last_only=True)
        _close(last, want["logits"][:, -1:], tol)
        _close_caches(caches, want["caches"], tol)
        for i, db in enumerate((d1, d2)):
            dl, caches = model.decode(params, _torch_batch(db), caches,
                                      S + i)
            assert dl.shape[:2] == (B, 1)
            _close(dl, want[f"decode{i}"][0], tol)
            _close_caches(caches, want[f"decode{i}"][1], tol)


@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_jax(name):
    """``ServeSession.generate`` (f32) gives the JAX package's tokens. A
    vlm's prefill needs its embeddings and 3-row positions, which the
    session does not pass: both packages' sessions raise there."""
    cfg, model, params = _port(name, "float32")
    jcfg = SMOKE_ARCHS[name].replace(dtype="float32")
    jsess = JSession(jbuild(jcfg), _tree(jnp.asarray, _weights(jcfg)))
    sess = ServeSession(model, params, device="cpu")
    shape = (B, cfg.n_codebooks, 8) if cfg.n_codebooks else (B, 8)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, shape) \
        .astype(np.int32)
    if cfg.family == "vlm":
        with pytest.raises(AssertionError):
            jsess.generate(jnp.asarray(toks), n_steps=STEPS)
        with pytest.raises(AssertionError):
            sess.generate(toks, n_steps=STEPS)
        return
    want = np.asarray(jsess.generate(jnp.asarray(toks), n_steps=STEPS))
    got = sess.generate(toks, n_steps=STEPS)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_matches_forward_dense():
    """Mirrors tests/test_system.py::test_decode_matches_forward_dense on
    the port: next-token logits from prefill + decode (against a cache one
    slot longer, so that nothing is overwritten) equal the sliced full
    forward, in bf16 at the reference's tolerance."""
    cfg, model, params = _port("qwen3-0.6b", "bfloat16")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    with torch.inference_mode():
        full, _, _ = model.forward(params, {"tokens": toks})
        _, caches = model.prefill(params, {"tokens": toks[:, :S]})
        caches = _tree(lambda c: torch.cat(
            [c, torch.zeros_like(c[..., :1, :, :])], dim=-3), caches)
        dl, _ = model.decode(params, {"tokens": toks[:, S:]}, caches, S)
    _close(dl[:, 0], full[:, S], BF16)


def test_int8_kv_cache_decode_close_to_bf16():
    """Mirrors tests/test_system.py::test_int8_kv_cache_decode_close_to_bf16
    on the port: the int8 cache's decode logits stay within 0.5 of the bf16
    cache's."""
    cfg, m, params = _port("qwen3-0.6b", "bfloat16")
    m8 = build_model(cfg.replace(kv_cache_dtype="int8"))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    with torch.inference_mode():
        _, c1 = m.prefill(params, {"tokens": toks[:, :S]})
        _, c8 = m8.prefill(params, {"tokens": toks[:, :S]})
        assert c8["scan"]["l0"]["k"].dtype == torch.int8
        d1, _ = m.decode(params, {"tokens": toks[:, S:]}, c1, S)
        d8, _ = m8.decode(params, {"tokens": toks[:, S:]}, c8, S)
    assert float((d1.float() - d8.float()).abs().max()) < 0.5


def test_attention_routes_agree_on_the_cpu():
    """``attention="cuda"`` on CPU tensors takes the plain version, the
    same function ``attention="torch"`` names: equal logits."""
    _, model, params = _port("gemma2-27b", "float32")
    _, plain, _ = _port("gemma2-27b", "float32", attention="torch")
    batch = _torch_batch(_batches(model.cfg)[0])
    with torch.inference_mode():
        a = model.forward(params, batch)[0]
        b = plain.forward(params, batch)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="attention"):
        build_model(model.cfg, attention="sdpa")


def test_session_defaults_to_the_card():
    """Without ``device`` the session asks for CUDA, and raises where there
    is none; ``device="cpu"`` is explicit."""
    assert not torch.cuda.is_available()
    cfg, model, params = _port("qwen3-0.6b", "bfloat16")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeSession(model, params)
    sess = ServeSession(model, params, device="cpu")
    assert sess.device == torch.device("cpu")
    # the casts at load: weights in bf16, norm scales in f32
    assert sess.params["scan"]["l0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert sess.params["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_blocks_wait_for_the_next_slice(name):
    with pytest.raises(NotImplementedError, match=RECURRENT_SLICE):
        build_model(T_SMOKE[name]).specs()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 7's golden check, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_golden_run(cs):
    (run,) = [r for r in cs.lm_golden() if r["smoke"]]
    return run


def test_golden_file_holds_on_the_cpu():
    """The golden file's smoke run (Gemma-2's local and global layers)
    through phase 7's check on the CPU: the numpy weights hash to the
    file's, and the port's tokens and logits agree with the JAX package's
    run that wrote it. The full-width run's config is the port's
    ``qwen3-0.6b`` at the file's depth."""
    cs = _chip_smoke()
    errs, row = cs.golden_errors(_smoke_golden_run(cs), torch.device("cpu"))
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, (errs, row)
    assert row["tokens_compared"] == row["steps"] and row["max_err"] < 1e-4
    (full,) = [r for r in cs.lm_golden() if not r["smoke"]]
    cfg = cs.lm_config(full)
    assert (cfg.name, cfg.d_model, cfg.vocab_size, cfg.dtype) == (
        "qwen3-0.6b", 1024, 151936, "float32")


def test_golden_check_fails_a_prefill_without_its_window():
    """Phase 7's golden check fails the port when its local layers' prefill
    ignores the sliding window (the planted fault
    ``lm.prefill_drops_window``), here by a config with none."""
    cs = _chip_smoke()
    run = _smoke_golden_run(cs)
    run = dict(run, overrides=dict(run["overrides"], sliding_window=None))
    errs, _ = cs.golden_errors(run, torch.device("cpu"))
    assert errs["weights"] == 0 and errs["logits"] > 0


def _shapes(tree, path=()) -> dict:
    """{key path: (shape, dtype name)} of a cache tree of either package
    (ShapeDtypeStructs, TensorSpecs or tensors)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _shapes(sub, path + (k,)).items()}
    return {path: (tuple(tree.shape),
                   str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_jax(name):
    """``cache_specs`` and ``init_caches`` give the reference's cache tree:
    the same keys, shapes and dtypes (int8 where the config asks for it),
    at a context longer than the smoke window."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    for kv in ("bfloat16", "int8"):
        want = _shapes(jtfm.cache_specs(
            SMOKE_ARCHS[name].replace(kv_cache_dtype=kv), 2, 24))
        cfg = T_SMOKE[name].replace(kv_cache_dtype=kv)
        assert _shapes(ttfm.cache_specs(cfg, 2, 24)) == want
        assert _shapes(ttfm.init_caches(cfg, 2, 24, "cpu")) == want
