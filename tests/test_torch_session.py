"""The port's language-model path (models + serve/session.py) against the
JAX package's, for each of the 10 smoke configs.

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
module (tests/test_torch_models.py::test_moe_matches_jax). The RWKV-6 and
RG-LRU configs (families ``ssm`` and ``hybrid``) carry their recurrent
states in the caches, compared leaf by leaf like the KV caches.
Mirrors tests/test_system.py: prefill/decode, decode against the sliced
forward (dense, RWKV-6, Griffin), the session and the int8 KV cache.
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
from repro_torch.serve.engine import ServeSession
from test_torch_models import BF16, F32, _close, _np

NAMES = sorted(SMOKE_ARCHS)
B, S, STEPS = 2, 32, 4
# bf16 logits of the recurrent families: the reference's own tolerance for
# them (tests/test_system.py::test_decode_matches_forward_rwkv and
# ::test_decode_matches_forward_griffin). Their f32 gates and scans differ
# from XLA's in the last bit of exp, log1p, tanh and the like, and a
# last-bit change flips a bf16 rounding of the state; on the Griffin smoke
# config the JAX package's own bf16 logits lie within 0.67-0.93 of BF16
# from its f32 ones over four weight seeds, and the port's within
# 0.84-1.06 of BF16 from the JAX package's bf16 ones
BF16_RECURRENT = dict(atol=3e-2, rtol=3e-2)


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
    ltol = BF16_RECURRENT if dtype == "bfloat16" and SMOKE_ARCHS[
        name].family in ("ssm", "hybrid") else tol
    want = _jax_run(name, dtype)
    cfg, model, params = _port(name, dtype)
    prompt, d1, d2 = _batches(cfg)
    with torch.inference_mode():
        logits, _, none = model.forward(params, _torch_batch(prompt))
        assert none is None
        _close(logits, want["logits"], ltol)
        logits, caches = model.prefill(params, _torch_batch(prompt))
        _close(logits, want["logits"], ltol)
        last, _ = model.prefill(params, _torch_batch(prompt), last_only=True)
        _close(last, want["logits"][:, -1:], ltol)
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


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_decode_matches_forward_recurrent(name):
    """Mirrors tests/test_system.py::test_decode_matches_forward_rwkv and
    ::test_decode_matches_forward_griffin on the port: prefill then one
    decode step (the global KV caches one slot longer; the local ones keep
    the window, whose ring evicts the oldest position) equal the sliced
    full forward, in bf16 at the reference's tolerance for these
    families."""
    cfg, model, params = _port(name, "bfloat16")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))

    def grow(c):
        if c.dim() >= 3 and c.shape[-3] == S:          # (.., B, S, KV, hd)
            return torch.cat([c, torch.zeros_like(c[..., :1, :, :])], dim=-3)
        return c
    with torch.inference_mode():
        full, _, _ = model.forward(params, {"tokens": toks})
        _, caches = model.prefill(params, {"tokens": toks[:, :S]})
        dl, _ = model.decode(params, {"tokens": toks[:, S:]},
                             _tree(grow, caches), S)
    _close(dl[:, 0], full[:, S], BF16_RECURRENT)


@pytest.mark.parametrize("S", [16, 13])
def test_local_ring_keeps_the_reference_off_a_window_multiple(S):
    """A finding in the reference that the port keeps (ROADMAP Queue 3):
    prefill leaves a local layer's last L = window keys at slots 0..L-1 in
    order, and decode writes position p at slot p % L. With a prompt of 16
    (a multiple of the smoke window, 8) the first decode step evicts the
    oldest key and equals the sliced forward; with 13 it overwrites a key
    inside the window and keeps one outside it, and leaves the forward,
    in the JAX package and in the port alike, which agree at ``F32``."""
    cfg, model, params = _port("recurrentgemma-9b", "float32")
    jcfg = SMOKE_ARCHS["recurrentgemma-9b"].replace(dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = _tree(jnp.asarray, _weights(jcfg))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    with torch.inference_mode():
        t = torch.as_tensor(toks)
        full, _, _ = model.forward(params, {"tokens": t})
        _, caches = model.prefill(params, {"tokens": t[:, :S]})
        dl, _ = model.decode(params, {"tokens": t[:, S:]}, caches, S)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    jdl, _ = jmodel.decode(jparams, {"tokens": jnp.asarray(toks[:, S:])}, jc,
                           jnp.asarray(S, jnp.int32))
    _close(dl, jdl, F32)
    off = float((dl[:, 0] - full[:, S]).abs().max())
    assert off < 1e-4 if S % cfg.sliding_window == 0 else off > 1e-2, off


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


FULL_WIDTH = {"rwkv6-1.6b": (2048, 2, 65536), "recurrentgemma-9b": (
    4096, 3, 256000)}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_recurrent_golden_file_holds_on_the_cpu(name):
    """The recurrent golden file's smoke run of ``name`` (RWKV-6's padded
    single chunk; Griffin's window of 8 and its ring wrapping) through
    phase 7's check on the CPU: the weights hash to the file's, tokens and
    logits agree with the JAX package's run that wrote it, every step
    compared. The full-width run's config is the port's at the file's
    depth."""
    cs = _chip_smoke()
    runs = [r for r in cs.lm_golden(cs.LM_GOLDEN_RECURRENT)
            if r["name"] == name]
    (run,) = [r for r in runs if r["smoke"]]
    errs, row = cs.golden_errors(run, torch.device("cpu"))
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, (errs, row)
    assert row["tokens_compared"] == row["steps"] and row["max_err"] < 1e-4
    (full,) = [r for r in runs if not r["smoke"]]
    cfg = cs.lm_config(full)
    assert (cfg.d_model, cfg.n_layers, cfg.vocab_size, cfg.dtype) == (
        *FULL_WIDTH[name], "float32")


def _plant(monkeypatch, cs, fault: str) -> None:
    """``chip_smoke.PLANTED_FAULTS[fault]`` in this process: its module's
    source with the fault's text replaced, executed, and each of its
    functions set, for the test, on the real module and on every
    ``repro_torch`` module that imported it by name."""
    import importlib
    import inspect
    import sys
    import types
    _, rel, text, stand_in = cs.PLANTED_FAULTS[fault]
    mod = importlib.import_module(
        "repro_torch." + rel.removesuffix(".py").replace("/", "."))
    src = inspect.getsource(mod)
    assert src.count(text) == 1, fault
    fake = types.ModuleType(mod.__name__)
    exec(compile(src.replace(text, stand_in), mod.__file__, "exec"),
         fake.__dict__)
    users = [m for n, m in sys.modules.items() if n.startswith("repro_torch")]
    for key, value in vars(fake).items():
        real = getattr(mod, key, None)
        if not inspect.isfunction(value) or not inspect.isfunction(real):
            continue
        for user in users:
            if getattr(user, key, None) is real:
                monkeypatch.setattr(user, key, value)


@pytest.mark.parametrize("fault,name,check", [
    ("lm.wkv_drops_inter_block", "rwkv6-1.6b", "logits"),
    ("lm.rglru_decode_drops_h_prev", "recurrentgemma-9b", "logits"),
    ("lm.cast_rglru_gates_bf16", "recurrentgemma-9b", "weights")])
def test_recurrent_golden_check_fails_planted_faults(monkeypatch, fault,
                                                     name, check):
    """Each of ``--plant-faults``' recurrent faults, planted here, fails
    the named check of phase 7's golden check on the smoke run: a WKV
    chunk without its inter-sub-block term, an RG-LRU decode step that
    ignores its state, and a cast at load that rounds the RG-LRU gates to
    bf16 (which leaves the weights the reference reads in f32 in bf16)."""
    cs = _chip_smoke()
    (run,) = [r for r in cs.lm_golden(cs.LM_GOLDEN_RECURRENT)
              if r["name"] == name and r["smoke"]]
    _plant(monkeypatch, cs, fault)
    errs, _ = cs.golden_errors(run, torch.device("cpu"))
    assert errs[check] > 0, errs


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_moe_golden_file_holds_on_the_cpu(name):
    """The MoE golden file's smoke run of ``name`` (4 experts, top-2)
    through phase 7's check on the CPU: the weights hash to the file's,
    tokens and logits agree with the JAX package's run, every step
    compared; the row carries the run's smallest router margin. The
    full-width Moonshot run's config is the port's at the file's depth."""
    cs = _chip_smoke()
    runs = [r for r in cs.lm_golden(cs.LM_GOLDEN_MOE) if r["name"] == name]
    (run,) = [r for r in runs if r["smoke"]]
    errs, row = cs.golden_errors(run, torch.device("cpu"))
    assert errs == {"weights": 0, "tokens": 0, "logits": 0}, (errs, row)
    assert row["tokens_compared"] == row["steps"] and row["max_err"] < 1e-4
    assert row["router_margin"] == run["router_margin"] > 0
    for full in (r for r in runs if not r["smoke"]):
        cfg = cs.lm_config(full)
        assert (cfg.d_model, cfg.n_layers, cfg.n_experts, cfg.top_k,
                cfg.moe_d_ff, cfg.vocab_size, cfg.dtype) == (
            2048, 1, 64, 6, 1408, 163840, "float32")


def test_moe_golden_check_fails_a_combine_without_an_expert(monkeypatch):
    """``--plant-faults``' ``lm.moe_combine_drops_expert`` (the combine
    drops expert 0's rows), planted here, fails the logits of phase 7's
    golden check on Moonshot's smoke run."""
    cs = _chip_smoke()
    (run,) = [r for r in cs.lm_golden(cs.LM_GOLDEN_MOE)
              if r["name"] == "moonshot-v1-16b-a3b" and r["smoke"]]
    _plant(monkeypatch, cs, "lm.moe_combine_drops_expert")
    errs, _ = cs.golden_errors(run, torch.device("cpu"))
    assert errs["logits"] > 0, errs


def test_init_check_fails_a_router_cast_to_bf16(monkeypatch):
    """``--plant-faults``' ``lm_init.router_cast_bf16``, planted here: the
    init in the serving dtypes leaves the MoE router in bf16, which
    ``f32_cast_errors`` counts (one a layer group)."""
    from repro_torch.models import build_model
    cs = _chip_smoke()
    cfg = T_SMOKE["moonshot-v1-16b-a3b"]
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    assert cs.f32_cast_errors(model.init_cast(gen, "cpu"), cfg) == 0
    _plant(monkeypatch, cs, "lm_init.router_cast_bf16")
    assert cs.f32_cast_errors(model.init_cast(gen, "cpu"), cfg) == 1


def test_exact_tie_needs_the_largest_logit_held_twice():
    """Phase 7's Moonshot argmax at an exact tie: the kernels' largest
    logit held by two tokens (3.78125 and 3.78125 on the card), the plain
    run's choice the second of them (3.765625 and 3.78125) agree on a
    greedy choice; the same pair one bf16 step apart on both runs, or a
    plain choice outside the tie, does not."""
    cs = _chip_smoke()
    g = torch.tensor([3.78125, 1.0, 3.78125, 0.5])
    assert cs.exact_tie(g, torch.tensor([3.765625, 1.0, 3.78125, 0.5]))
    assert cs.exact_tie(torch.tensor([3.765625, 1.0, 3.78125, 0.5]), g)
    assert not cs.exact_tie(torch.tensor([3.78125, 1.0, 3.765625, 0.5]),
                            torch.tensor([3.765625, 1.0, 3.78125, 0.5]))
    assert not cs.exact_tie(g, torch.tensor([3.765625, 1.0, 3.75, 3.78125]))


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
