"""Guards against drift between the port's copies and the JAX package.

The port keeps its own copies of the JAX-free VTA plane (tps, isa, runtime,
graph, workloads, lowering, scheduler, compiler, the numpy FSim and the
trace recorder): the Program and the Trace they build, the FSim's outputs
and the recorder's digests must stay identical to the JAX package's.
Tolerance: 0 — the 128-bit instruction encodings, every index array and
every output byte are compared exactly.
"""
import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.serve import model as jmodel
from repro.vta import isa as jisa
from repro.vta.lowering import lower_cached as j_lower_cached
from repro_torch.serve import model as tmodel
from repro_torch.vta import isa as tisa
from repro_torch.vta.lowering import lower_cached as t_lower_cached
from test_torch_serve import _j_trunk_graph

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import repro_torch, repro_torch.kernels\n"
        "import repro_torch.kernels.vta_gemm, repro_torch.kernels.alu_sweep\n"
        "import repro_torch.kernels._build\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.vta.fsim_torch, repro_torch.vta.backend\n"
        "import repro_torch.vta.fsim, repro_torch.vta.trace\n"
        "import repro_torch.serve.engine, repro_torch.serve.model\n"
        "import repro_torch.serve.breaker, repro_torch.serve.workers\n"
        "from repro_torch.serve.model import served_model\n"
        "m = served_model('resnet18', 'tiny')\n"
        "m.run_batch(m.random_images(1), 'torch-cpu')\n"
        "from repro_torch.serve.engine import VTAServeEngine\n"
        "from repro_torch.serve.workers import WorkerPool\n"
        "pool = WorkerPool({'m': m}, 1, transport='inline',\n"
        "                  ladder=('torch-cpu', 'numpy'))\n"
        "eng = VTAServeEngine({'m': m}, buckets=(1,), workers=pool)\n"
        "t = eng.submit('a', 'm', m.random_images(1)[0])\n"
        "eng.drain()\n"
        "assert t.ok, t.status\n"
        "from repro_torch.vta.trace import record_trace\n"
        "seg = m.segments[0].program\n"
        "dram = {t: np.zeros(s, np.int8) for t, s in m.shapes.items()}\n"
        "dram.update(m.weights)\n"
        "steps = [record_trace(seg, m.hw, dict(dram), backend=b)\n"
        "         for b in ('numpy', 'torch-cpu')]\n"
        "assert [s.digests for s in steps[0]] == \\\n"
        "    [s.digests for s in steps[1]]\n"
        "import torch\n"
        "x = torch.ones((1, 2, 4, 8))\n"
        "repro_torch.kernels.ops.flash_attention(x, x[:, :1], x[:, :1],\n"
        "                                        window=2, softcap=5.0)\n"
        "import repro_torch.configs, repro_torch.sharding\n"
        "import repro_torch.models.layers, repro_torch.models.attention\n"
        "import repro_torch.models.moe, repro_torch.models.transformer\n"
        "import repro_torch.models.convert, repro_torch.serve.session\n"
        "import repro_torch.models.rwkv6, repro_torch.models.griffin\n"
        "from repro_torch.configs import SMOKE_ARCHS\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.models.convert import numpy_params\n"
        "from repro_torch.serve.engine import ServeSession\n"
        "for name in ('qwen3-0.6b', 'rwkv6-1.6b', 'recurrentgemma-9b'):\n"
        "    cfg = SMOKE_ARCHS[name]\n"
        "    sess = ServeSession(build_model(cfg), repro_torch.models.\n"
        "        convert.params_from_numpy(numpy_params(cfg, 0), 'cpu'),\n"
        "        device='cpu')\n"
        "    out = sess.generate(np.ones((2, 8), np.int32), n_steps=3)\n"
        "    assert tuple(out.shape) == (2, 3), out.shape\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_recurrent_constants_match_the_originals():
    """The constants the recurrent blocks copy from the reference: RWKV-6's
    log-decay floor and sub-block size, the RG-LRU's gate constant."""
    from repro.models import griffin as jgriffin
    from repro.models import rwkv6 as jrwkv6
    from repro_torch.models import griffin as tgriffin
    from repro_torch.models import rwkv6 as trwkv6
    assert (trwkv6.LW_CLAMP, trwkv6.SUB) == (jrwkv6.LW_CLAMP, jrwkv6.SUB)
    assert tgriffin.RGLRU_C == jgriffin.RGLRU_C


def test_config_copies_match_the_originals():
    """The port's ``configs/`` is a copy: every config of ``ARCHS``,
    ``SMOKE_ARCHS`` and ``SHAPES`` equals the JAX package's field by
    field, and so do the properties the models read."""
    from repro import configs as jc
    from repro_torch import configs as tc
    for name in ("ARCHS", "SMOKE_ARCHS", "SHAPES"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert list(a) == list(b), name
        for key in a:
            assert dataclasses.asdict(a[key]) == dataclasses.asdict(b[key])
    for key, cfg in jc.ARCHS.items():
        port = tc.ARCHS[key]
        assert (cfg.layer_kinds, cfg.n_groups, cfg.param_count(),
                cfg.active_param_count(), cfg.long_context_capable) == (
            port.layer_kinds, port.n_groups, port.param_count(),
            port.active_param_count(), port.long_context_capable)
        assert dataclasses.asdict(jc.smoke_variant(cfg)) == \
            dataclasses.asdict(tc.smoke_variant(port))


def test_breaker_transitions_match_the_original():
    """The port's ``CircuitBreaker`` (a copy) moves through the same states
    at the same times as the JAX package's on one scripted sequence of
    admissions, failures and successes."""
    from repro.serve.breaker import CircuitBreaker as JBreaker
    from repro_torch.serve.breaker import CircuitBreaker as TBreaker
    script = [("allow", 0.0), ("fail", 0.0), ("fail", 0.1), ("fail", 0.2),
              ("allow", 0.5), ("allow", 1.3), ("fail", 1.3), ("allow", 1.9),
              ("allow", 2.4), ("ok", 2.4), ("fail", 2.5), ("ok", 2.6),
              ("fail", 2.7), ("fail", 2.8), ("fail", 2.9), ("allow", 4.0),
              ("ok", 4.0)]

    def run(cls):
        seen = []
        br = cls("k", fail_threshold=3, cooldown_s=1.0,
                 on_transition=lambda *a: seen.append(a))
        steps = []
        for op, now in script:
            if op == "allow":
                steps.append(br.allow(now))
            elif op == "fail":
                br.on_failure(now)
            else:
                br.on_success(now)
            steps.append((br.state, br.consecutive_failures, br.opened_at))
        return steps, br.transitions, seen

    got, want = run(TBreaker), run(JBreaker)
    assert got == want
    assert len(want[1]) >= 5


def _canon(x):
    """A comparable, package-independent form of lowering output."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _canon(getattr(x, f.name)))
            for f in dataclasses.fields(x)
            if f.name not in ("hw", "insns"))
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(x))
    if isinstance(x, dict):
        return tuple(sorted((k, _canon(v)) for k, v in x.items()))
    raise TypeError(type(x))


def _assert_same_model(a, b):
    assert len(a.segments) == len(b.segments)
    assert (a.input_name, a.output_name) == (b.input_name, b.output_name)
    shapes_a = dict(a.shapes) | {k: v.shape for k, v in a.weights.items()}
    shapes_b = dict(b.shapes) | {k: v.shape for k, v in b.weights.items()}
    assert shapes_a == shapes_b
    for sa, sb in zip(a.segments, b.segments):
        pa, pb = sa.program, sb.program
        assert len(pa.order) == len(pb.order)
        assert [jisa.encode_insn(i, a.hw) for i in pa.order] == \
            [tisa.encode_insn(i, b.hw) for i in pb.order]
        assert [u.encode(a.hw) for u in pa.uop_mem] == \
            [u.encode(b.hw) for u in pb.uop_mem]
        assert bool(getattr(pa, "fused_segment", False)) == \
            bool(getattr(pb, "fused_segment", False))
        ta = j_lower_cached(pa, a.hw, shapes_a)
        tb = t_lower_cached(pb, b.hw, shapes_b)
        assert _canon(ta) == _canon(tb)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet"])
@pytest.mark.parametrize("scale", ["tiny", "small"])
def test_serve_graphs_compile_identically(name, scale):
    _assert_same_model(jmodel.served_model(name, scale),
                       tmodel.served_model(name, scale))


def test_full_width_trunk_compiles_identically():
    a = jmodel.ServedModel.compile("resnet18-trunk", _j_trunk_graph(),
                                   jisa.DEFAULT_VTA)
    b = tmodel.ServedModel.compile("resnet18-trunk",
                                   tmodel.resnet18_trunk_graph(),
                                   tisa.DEFAULT_VTA)
    assert a.graph.describe() == b.graph.describe()
    for k, v in a.weights.items():
        np.testing.assert_array_equal(b.weights[k], v)
    _assert_same_model(a, b)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet"])
def test_numpy_fsim_copy_matches_the_original(name):
    """The port's ``vta/fsim.py`` gives the JAX package's numpy backend's
    bytes, segment by segment, on the served models."""
    a = jmodel.served_model(name, "small")
    b = tmodel.served_model(name, "small")
    img = a.random_images(1, seed=6)[0]
    np.testing.assert_array_equal(b.run_single(img, "numpy"),
                                  a.run_single(img, "numpy"))
    np.testing.assert_array_equal(b.run_batch(img[None], "numpy"),
                                  a.run_batch(img[None], "numpy"))


def test_numpy_fsim_references_match_the_original():
    from repro.vta import fsim as jfsim
    from repro_torch.vta import fsim as tfsim
    rng = np.random.default_rng(8)
    x = rng.integers(-128, 128, (2, 16, 9, 9), dtype=np.int8)
    w = rng.integers(-8, 8, (32, 16, 3, 3), dtype=np.int8)
    dw = rng.integers(-8, 8, (16, 3, 3), dtype=np.int8)
    for fn, args in (("conv2d_ref", (x, w, (2, 2), (1, 1))),
                     ("depthwise_ref", (x, dw, (1, 1), (1, 1)))):
        got = getattr(tfsim, fn)(*args)
        np.testing.assert_array_equal(got, getattr(jfsim, fn)(*args))
        for post in ("relu_shift", "clip_shift"):
            np.testing.assert_array_equal(tfsim.post_op_ref(got, post),
                                          jfsim.post_op_ref(got, post))
    for mode in ("max", "avg"):
        args = (x, (3, 3), (2, 2), (1, 1), mode)
        np.testing.assert_array_equal(tfsim.pool_ref(*args),
                                      jfsim.pool_ref(*args))


def test_trace_copy_digests_match_the_original():
    """The port's ``vta/trace.py`` records the JAX package's digests, step
    by step, on one depthwise program."""
    from repro.core.tps import ConvWorkload as JConvWorkload
    from repro.vta import scheduler as jsched
    from repro.vta.trace import record_trace as j_record_trace
    from repro_torch.core.tps import ConvWorkload
    from repro_torch.vta import scheduler as tsched
    from repro_torch.vta.trace import record_trace
    args = ("dw", 1, 8, 8, 3, 3, 16, 16, 1, 1, 2, 2)
    jprog = jsched.schedule_depthwise(JConvWorkload(*args, depthwise=True),
                                      jisa.DEFAULT_VTA).program
    tprog = tsched.schedule_depthwise(ConvWorkload(*args, depthwise=True),
                                      tisa.DEFAULT_VTA).program
    rng = np.random.default_rng(3)
    dram = {"inp": rng.integers(-128, 128, (1, 16, 8, 8), dtype=np.int8),
            "dw_wgt": rng.integers(-8, 8, (16, 3, 3), dtype=np.int8),
            "out": np.zeros((1, 16, 4, 4), np.int8)}
    a = j_record_trace(jprog, jisa.DEFAULT_VTA,
                       {k: v.copy() for k, v in dram.items()})
    b = record_trace(tprog, tisa.DEFAULT_VTA,
                     {k: v.copy() for k, v in dram.items()})
    assert len(a) == len(b) == len(tprog.order)
    assert [(s.step, s.insn, s.digests) for s in a] == \
        [(s.step, s.insn, s.digests) for s in b]
