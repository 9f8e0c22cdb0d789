"""The port's multi-pod dry-run (repro_torch/launch/dryrun.py), its attention
op registration and its step under logical rules, on the CPU.

Dry-run cells run on smoke configs at small shapes on a (2, 4) fake mesh
(``launch.mesh.PRODUCTION_SHAPES`` patched), train, prefill and decode, for
the dense family and the two recurrent ones: ``argument_bytes`` is the local
shard bytes of the JAX package's specs (0 tolerance), train flops per device
lie in ``TRAIN_FLOP_BAND`` times ``model_flops / world``, and collectives are
counted. A MoE cell ends with the op it fails on. On a one-rank ``gloo``
mesh, the train step and the serving session under rules equal the same
without rules by bits, every gradient and updated param in its param's
placements.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.launch.specs import _CACHE_DIM_NAMES as J_CACHE_NAMES
from repro.models.registry import build_model as j_build_model
from repro.sharding.logical import DEFAULT_RULES as J_RULES
from repro.sharding.logical import LogicalRules as JRules
from repro_torch.analysis.roofline import model_flops
from repro_torch.configs import ARCHS, SHAPES, SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import (destroy_process_group, init_process_group,
                                     make_mesh)
from repro_torch.models import build_model
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.sharding.logical import LogicalRules, use_rules
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import flatten_dict, tree_map

MESH = ((2, 4), ("data", "model"))
WORLD = 8
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode")}
# remat "full" runs each group's forward twice and the loss head's chunks
# twice (8 of the 6 * N * tokens of model_flops), and ops on tensors the
# rules leave replicated over "model" count whole on every rank; the flop
# formulas count products only, so weights used element-wise (RWKV-6's
# per-channel mixes) are in N but add no flops: 1.2 below, 2.5 above
TRAIN_FLOP_BAND = (1.2, 2.5)


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _jrules():
    r = JRules.__new__(JRules)
    r.mesh = _FakeMesh(*MESH)
    r.rules = dict(J_RULES)
    r.act_overrides = {}
    return r


@pytest.fixture
def small_cells(monkeypatch):
    """The (2, 4) mesh, small shapes, and each arch's smoke config."""
    monkeypatch.setitem(tmesh.PRODUCTION_SHAPES, False, MESH)
    for k, v in SMALL.items():
        monkeypatch.setitem(SHAPES, k, v)
    for a, cfg in SMOKE_ARCHS.items():
        monkeypatch.setitem(ARCHS, a, cfg)


@pytest.fixture
def group():
    yield init_process_group
    destroy_process_group()


def _local_bytes(shape, spec, itemsize) -> int:
    """Rank 0's shard bytes of a tensor of ``shape`` under a JAX ``spec``:
    each dim cut by the product of its axes' sizes, rounded up."""
    sizes = dict(zip(MESH[1], MESH[0]))
    n = 1
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n * itemsize


def jax_argument_bytes(arch: str, shape_name: str) -> int:
    """The step's argument bytes on rank 0, from the JAX package's specs:
    f32 params (with AdamW's mu, nu and int32 step for train), int32
    tokens (and labels), and for decode the caches."""
    cfg, shape = J_SMOKE[arch], SMALL[shape_name]
    model, r = j_build_model(cfg), _jrules()
    p = sum(_local_bytes(s.shape, r.spec(s.names, s.shape), 4)
            for s in jax.tree_util.tree_leaves(
                model.specs(), is_leaf=lambda x: hasattr(x, "names")))
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    tok = _local_bytes((B, S), r.spec(("batch", "seq"), (B, S), is_act=True), 4)
    if shape.kind == "train":
        return 3 * p + 4 + 2 * tok
    if shape.kind == "prefill":
        return p + tok
    caches = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            model.cache_specs(B, shape.seq_len)):
        names = J_CACHE_NAMES[path[-1].key]
        names = names[-leaf.ndim:] if leaf.ndim < len(names) else names
        names = (None,) * (leaf.ndim - len(names)) + tuple(names)
        caches += _local_bytes(leaf.shape, r.spec(names, leaf.shape,
                                                  is_act=True),
                               np.dtype(leaf.dtype).itemsize)
    return p + tok + caches


@pytest.mark.parametrize("shape", sorted(SMALL))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-27b", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_dryrun_smoke_cell(small_cells, arch, shape):
    res = dryrun.run_cell(arch, shape, verbose=False)
    assert "error" not in res, res["error"]
    assert (res["mesh"], res["chips"]) == ("2x4", WORLD)
    mem = res["memory"]
    assert mem["argument_bytes"] == jax_argument_bytes(arch, shape)
    assert mem["peak_est_bytes"] == mem["argument_bytes"] + mem[
        "output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    assert mem["temp_bytes"] > 0 and res["hbm_bytes_per_device"] > 0
    colls = res["collectives"]
    assert colls["total_bytes"] > 0
    assert colls["total_bytes"] == sum(colls["bytes_by_axis"].values())
    assert set(colls["bytes_by_axis"]) <= {"data", "model"}
    ratio = res["flops_per_device"] * WORLD / model_flops(ARCHS[arch], shape)
    if SMALL[shape].kind == "train":
        assert TRAIN_FLOP_BAND[0] <= ratio <= TRAIN_FLOP_BAND[1], ratio
    if SMALL[shape].kind == "decode" and arch != "rwkv6-1.6b":
        # the attention caches are written in place: outputs that alias
        # the arguments
        assert mem["alias_bytes"] > 0


def test_dryrun_names_the_failing_op(small_cells):
    """A MoE cell ends with ``"error"`` naming the op DTensor cannot run
    (the dispatch's ``index_put_`` of DTensor values into a plain table),
    as the reference's sweep records a failed cell; the CLI exits 1."""
    res = dryrun.run_cell("mixtral-8x22b", "prefill_32k", verbose=False)
    assert "index_put_" in res["error"] and "moe.py" in res["error"]
    assert "flops_per_device" not in res


def test_dryrun_cli(small_cells, tmp_path, capsys):
    assert dryrun.main(["--list-cells"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 34 and lines[0] == "qwen3-0.6b train_4k"
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "prefill_32k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "mixtral-8x22b", "--shape", "decode_32k",
                        "--out", str(tmp_path / "moe.json")]) == 1
    assert "error" in (tmp_path / "moe.json").read_text()
    capsys.readouterr()
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                        "--explain-collectives", "--out", str(out)]) == 0
    colls = json.loads(out.read_text())["collectives"]
    assert sum(r["bytes"] for r in colls["by_cause"]) == colls["total_bytes"]
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if " B " in ln and "x " in ln]
    assert len(printed) == min(dryrun.EXPLAIN_TOP, len(colls["by_cause"]))


def test_sps_search_ranks_candidates(small_cells, monkeypatch):
    """SPS runs the six rule tables as cells and ranks them by (over the
    cap, collective bytes, HBM bytes); a cap between the candidates'
    peaks puts the ones over it last."""
    from repro_torch.core import sharding_search as sps
    res = sps.sps_search("qwen3-0.6b", "prefill_32k", verbose=False)
    assert len(res) == 6 and all(r.feasible for r in res)
    assert [r.coll_bytes for r in res] == sorted(r.coll_bytes for r in res)
    peaks = sorted({r.peak_gib for r in res})
    assert len(peaks) > 1
    monkeypatch.setattr(sps, "HBM_CAP_GIB", peaks[0])
    res = sps.sps_search("qwen3-0.6b", "prefill_32k", verbose=False)
    assert res == sorted(res, key=lambda r: r.key())
    assert res[0].feasible and not res[-1].feasible


# --------------------------------------------------------------------------
# the attention ops
# --------------------------------------------------------------------------
def _qkv(seed=0, b=2, h=4, kv=2, s=16, d=16):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         requires_grad=True)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def test_attention_op_fake_shape_and_no_scores():
    """Under fake tensors the op gives the output's shape and allocates no
    S x S scores; its flop formula is 4 * B * H * D per visible pair."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        q = torch.empty(2, 8, 4096, 128)
        k = torch.empty(2, 2, 4096, 128)
        with FlopCounterMode(display=False) as fc:
            out = fa.flash_attention(q, k, k, window=1024)
    assert tuple(out.shape) == (2, 8, 4096, 128)
    pairs = fa.visible_pairs(4096, 4096, True, 1024)
    assert pairs == sum(min(i + 1, 1024) for i in range(4096))
    assert fc.get_total_flops() == 4 * 2 * 8 * 128 * pairs
    assert fa.visible_pairs(16, 16, True, None) == 16 * 17 // 2


def test_attention_op_gradients_equal_plain_path():
    """The op's gradient is ``flash_attention_backward`` by bits, and its
    forward ``flash_attention_plain``'s on CPU tensors."""
    q, k, v = _qkv()
    out = fa.flash_attention(q, k, v, window=5, softcap=4.0)
    dout = torch.ones_like(out) * 0.5
    out.backward(dout)
    want = fa.flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                       dout, window=5, softcap=4.0)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)
    assert torch.equal(out.detach(), fa.flash_attention_plain(
        q.detach(), k.detach(), v.detach(), window=5, softcap=4.0))


def test_attention_op_dtensor_one_rank_equals_plain(group):
    from torch.distributed.tensor import Shard, distribute_tensor
    group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    q, k, v = _qkv(1)
    dq, dk, dv = (distribute_tensor(t.detach(), mesh, [Shard(0), Shard(1)])
                  .requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(dq, dk, dv)
    out.sum().backward()
    ref = fa.flash_attention(q, k, v)
    ref.sum().backward()
    assert torch.equal(out.full_tensor(), ref.detach())
    assert torch.equal(dk.grad.full_tensor(), k.grad)
    assert list(out.placements) == [Shard(0), Shard(1)]


def test_attention_sharding_rule(group):
    """On a (2, 4) fake mesh: batch and heads shard, seq and head_dim stay
    whole; no heads strategy where KV does not divide the mesh dims."""
    from torch.distributed.tensor import Shard, distribute_tensor
    group("fake", WORLD)
    mesh = make_mesh(*MESH, device_type="cpu")

    def run(kv, placements):
        q = distribute_tensor(torch.empty(4, 8, 32, 16, device="meta"), mesh,
                              placements)
        k = distribute_tensor(torch.empty(4, kv, 32, 16, device="meta"), mesh,
                              placements)
        return fa.flash_attention(q, k, k)
    out = run(4, [Shard(0), Shard(1)])
    assert list(out.placements) == [Shard(0), Shard(1)]
    assert tuple(out.to_local().shape) == (2, 2, 32, 16)
    out = run(2, [Shard(0), Shard(2)])     # seq sharded on "model"
    assert not any(p.is_shard(2) or p.is_shard(1) for p in out.placements)


# --------------------------------------------------------------------------
# the step under rules on a one-rank mesh, by bits
# --------------------------------------------------------------------------
def _distributed(tree, mesh, rules):
    from torch.distributed.tensor import distribute_tensor
    names = build_model(SMOKE_ARCHS["qwen3-0.6b"]).logical_names()
    return tree_map(lambda t, n: distribute_tensor(
        t, mesh, rules.sharding(n, t.shape).placements()), tree, names)


def test_train_step_under_rules_equals_plain(group):
    from torch.distributed.tensor import DTensor
    group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    rules = LogicalRules(mesh)
    cfg = SMOKE_ARCHS["qwen3-0.6b"].replace(dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, 0), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in make_batch(
        DataConfig(batch=2, seq_len=16), cfg, 0).items()}
    step = make_train_step(model, AdamWConfig())
    p1, s1, m1 = step(params, init_opt_state(params), batch)
    dparams = _distributed(params, mesh, rules)
    with use_rules(rules):
        p2, s2, m2 = step(dparams, init_opt_state(dparams), batch)
    for key in ("loss", "grad_norm"):
        got = m2[key].full_tensor() if isinstance(m2[key], DTensor) \
            else m2[key]
        assert torch.equal(got, m1[key]), key
    want = flatten_dict(dparams)
    for tree, ref in ((p2, p1), (s2["mu"], s1["mu"]), (s2["nu"], s1["nu"])):
        for k, t in flatten_dict(tree).items():
            assert list(t.placements) == list(want[k].placements), k
            assert torch.equal(t.full_tensor(), flatten_dict(ref)[k]), k


def test_serve_session_under_rules_equals_plain(group):
    from repro_torch.serve.session import ServeSession
    group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    rules = LogicalRules(mesh)
    cfg = SMOKE_ARCHS["qwen3-0.6b"]
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, 0), "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    want = ServeSession(model, params, device="cpu").generate(prompts, 4)
    sess = ServeSession(model, _distributed(params, mesh, rules),
                        device="cpu")
    with use_rules(rules):
        got = sess.generate(prompts, 4)
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    assert torch.equal(got, want)


def test_ring_write_lands_in_the_owning_shard(group):
    """A decode write into a cache whose slot dim (``kv_seq``) is sharded:
    rank 0 holds slots 0-7 of 16 and takes slot 3 in its own shard, and
    writes nothing for slot 12; DTensor's own slice assignment would
    write into a gathered copy and lose it."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.attention import write_slot
    group("fake", WORLD)
    mesh = make_mesh(*MESH, device_type="cpu")
    cache = distribute_tensor(torch.zeros(1, 16, 2, 8), mesh,
                              [Shard(1), Replicate()], src_data_rank=None)
    new = distribute_tensor(torch.ones(1, 1, 2, 8), mesh,
                            [Replicate(), Replicate()], src_data_rank=None)
    write_slot(cache, 3, new)
    assert cache.to_local()[:, 3].sum() == 16 == cache.to_local().sum()
    write_slot(cache, 12, new)
    assert cache.to_local().sum() == 16
    lost = distribute_tensor(torch.zeros(1, 16, 2, 8), mesh,
                             [Shard(1), Replicate()], src_data_rank=None)
    lost[:, 3:4] = new
    assert lost.to_local().sum() == 0


def test_merge_and_split_dims_of_sharded_tensors(group):
    """``merge_dims``, ``split_dim`` and ``linear`` on DTensors whose later
    merged dim is sharded (a sequence-parallel activation), forward and
    backward: the later dim's mesh dim is replicated first, the leading
    one kept; on plain tensors they are ``reshape``, ``view`` and
    ``matmul``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.sharding.logical import linear, merge_dims, split_dim
    group("fake", WORLD)
    mesh = make_mesh(*MESH, device_type="cpu")
    x = distribute_tensor(torch.empty(8, 16, 12, device="meta"), mesh,
                          [Shard(0), Shard(1)]).requires_grad_()
    w = distribute_tensor(torch.empty(12, 6, device="meta"), mesh,
                          [Replicate(), Shard(1)]).requires_grad_()
    y = merge_dims(x, 0)
    assert tuple(y.shape) == (128, 12)
    assert list(y.placements) == [Shard(0), Replicate()]
    z = split_dim(y, 0, (8, 16))
    out = linear(z, w)
    assert tuple(out.shape) == (8, 16, 6)
    out.sum().backward()
    assert tuple(x.grad.shape) == (8, 16, 12)
    assert tuple(w.grad.shape) == (12, 6)
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(merge_dims(t, 0), t.reshape(6, 4))
    assert torch.equal(split_dim(t, 2, (2, 2)), t.view(2, 3, 2, 2))
    m = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(linear(t, m), torch.matmul(t, m))


def test_linear_gathers_fsdp_weights(group):
    """``linear`` gathers a weight over the mesh dims on which it shards its
    contracting dim and ``x`` does not (FSDP), and keeps the one where
    ``x`` shards it too (row-parallel, a ``Partial`` output): one
    all-gather of the weight's shard, the output never a ``Partial`` of
    ``x``'s rows, and the gradient back in the weight's placements."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.sharding.logical import linear
    group("fake", WORLD)
    mesh = make_mesh(*MESH, device_type="cpu")

    def meta(shape, pl):
        return distribute_tensor(torch.empty(*shape, device="meta"), mesh,
                                 pl).requires_grad_()
    x, w = meta((8, 16), [Shard(0), Replicate()]), meta((16, 12),
                                                      [Shard(0), Shard(1)])
    with CollectiveCounter(mesh, explain=True) as c:
        out = linear(x, w)
    assert list(out.placements) == [Shard(0), Shard(1)]
    assert c.stats.to_dict()["bytes_by_kind"] == {"all-gather": 8 * 3 * 4}
    (row,) = c.stats.to_dict()["by_cause"]
    assert row["cause"].startswith(
        "redistribute (16, 12) [S(0), S(1)] -> [R, S(1)] @ "
        "sharding/logical.py:"), row
    with CollectiveCounter(mesh) as c:
        out.sum().backward()
    assert list(w.grad.placements) == [Shard(0), Shard(1)]
    assert c.stats.count_by_kind.get("reduce-scatter") == 1
    x, w = meta((8, 16), [Shard(0), Shard(1)]), meta((16, 12),
                                                   [Shard(1), Shard(0)])
    with CollectiveCounter(mesh) as c:
        out = linear(x, w)
    assert list(out.placements) == [Shard(0), Partial()]
    assert c.stats.to_dict()["bytes_by_axis"] == {"data": 4 * 6 * 4}


def test_vocab_logsumexp_gathers_no_logits(group):
    """The logsumexp of logits sharded over the vocab moves only the
    per-row max and sum (two all-reduces of a row each), forward and
    backward, where DTensor's own rule gathers the whole vocab; its
    gradient stays in the logits' placements. On plain tensors it is
    ``torch.logsumexp``."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.models.layers import vocab_logsumexp
    group("fake", WORLD)
    mesh = make_mesh(*MESH, device_type="cpu")
    logits = distribute_tensor(torch.empty(4, 8, 32, device="meta"), mesh,
                               [Shard(0), Shard(2)]).requires_grad_()
    with CollectiveCounter(mesh, explain=True) as c:
        vocab_logsumexp(logits).sum().backward()
    rows = c.stats.to_dict()["by_cause"]
    assert {r["kind"] for r in rows} == {"all-reduce"}
    assert sum(r["count"] for r in rows) == 2
    assert all(r["bytes"] == 2 * 8 * 4 for r in rows)     # (4/2, 8, 1) f32
    assert list(logits.grad.placements) == [Shard(0), Shard(2)]
    t = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(vocab_logsumexp(t), torch.logsumexp(t, dim=-1))


def test_vocab_parallel_lookup_and_gold_logit(group):
    """With the vocab sharded over "model" (4 ranks), rank 0 holds rows
    0-3: the lookup and the gold logit are, on rank 0, the values of the
    tokens in its slice and 0 for the rest, summed over "model" as a
    ``Partial``; plain tensors take ``w[tokens]`` and ``gather``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.layers import embed_lookup, gold_logit
    group("fake", WORLD)
    mesh = make_mesh(*MESH, device_type="cpu")
    w = torch.arange(64.0).reshape(16, 4)
    tok = torch.tensor([[0, 3, 4, 15, 2], [7, 1, 1, 9, 0]])
    inside = (tok < 4)[..., None]
    dw = distribute_tensor(w, mesh, [Replicate(), Shard(0)],
                           src_data_rank=None)
    got = embed_lookup(dw, tok)
    assert list(got.placements) == [Replicate(), Partial()]
    assert torch.equal(got.to_local(), torch.where(inside, w[tok], 0.0))
    logits = w[None].expand(2, 16, 4).transpose(1, 2).contiguous()  # (2,4,16)
    labels = tok[:, :4]
    dl = distribute_tensor(logits, mesh, [Shard(0), Shard(2)],
                           src_data_rank=None)
    g = gold_logit(dl, labels)
    assert list(g.placements) == [Shard(0), Partial()]
    want = torch.gather(logits, -1, labels[..., None])[..., 0]
    assert torch.equal(g.to_local(), torch.where(labels < 4, want, 0.0)[:1])
    assert torch.equal(embed_lookup(w, tok), w[tok])
    assert torch.equal(gold_logit(logits, labels), want)


def test_collectives_match_the_reference_hlo(tmp_path):
    """Qwen3-0.6B train_4k at full width on 16x16: the port's collective
    bytes a device against the JAX package's, parsed from its compiled HLO
    (``repro.launch.dryrun`` on 256 host devices, in subprocesses), at
    depth d1 and d2. Extrapolated to the 28 layers as the reference's
    roofline does (d1 + 27 (d2 - d1)), the totals agree within 1.5x either
    way (1.06x measured): the per-kind split differs (GSPMD all-reduces
    and all-to-alls where DTensor reduce-scatters and gathers), the bytes
    moved do not. A port that leaves DTensor to pick each product's input
    moves alone gave 1.8x, a ``Partial`` of the whole logits per chunk.
    The port's peak at d1 is at most the reference's (4.5 against 17.9
    GB): DTensor's own logsumexp gathers each chunk's whole vocab (18.7)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, "src")),
               JAX_PLATFORMS="cpu")
    procs = {d: subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "qwen3-0.6b",
         "--shape", "train_4k", "--depth", d, "--out",
         str(tmp_path / f"{d}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for d in ("d1", "d2")}
    port = {d: dryrun.run_cell("qwen3-0.6b", "train_4k", depth=d,
                               verbose=False) for d in ("d1", "d2")}
    for d, p in procs.items():
        assert p.wait(timeout=300) == 0, p.stdout.read()[-3000:]
    ref = {d: json.loads((tmp_path / f"{d}.json").read_text())
           for d in ("d1", "d2")}

    def full(res):
        b = {d: res[d]["collectives"]["total_bytes"] for d in ("d1", "d2")}
        return b["d1"] + (ARCHS["qwen3-0.6b"].n_layers - 1) * (
            b["d2"] - b["d1"])
    ratio = full(port) / full(ref)
    assert 1 / 1.5 <= ratio <= 1.5, (ratio, full(port), full(ref))
    assert port["d1"]["memory"]["peak_est_bytes"] <= \
        ref["d1"]["memory"]["peak_est_bytes"]
