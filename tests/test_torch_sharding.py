"""The port's logical sharding (repro_torch/sharding, launch/{mesh,specs},
models/layers.abstract_tree, train/step.abstract_params, the elastic
re-mesh) against the JAX package's.

``tests/test_sharding.py``'s eight tests run on the port's
``LogicalRules`` (the duck-typed ``_FakeMesh`` carries over), the last on a
one-rank ``gloo`` mesh with ``lshard`` on a DTensor. Then every param leaf
of all 10 architectures, and every runnable cell's batch and cache, get the
same spec from the port as from the JAX package on both production meshes
(the JAX package's on its own 256/512-device meshes, in a subprocess with
that many host devices). Tolerance: 0, specs compared entry by entry and
restored checkpoints by bits.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models.registry import build_model as j_build_model
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import ARCHS, SHAPES, SMOKE_ARCHS
from repro_torch.launch import dryrun, mesh as tmesh, specs as tspecs
from repro_torch.launch.mesh import (destroy_process_group, init_process_group,
                                     make_mesh, make_production_mesh)
from repro_torch.models import build_model, layers as tlayers
from repro_torch.sharding.logical import (DEFAULT_RULES, LogicalRules, P,
                                          PartitionSpec, spec_placements)
from repro_torch.train import step as tstep
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import abstract_opt_state, abstract_params
from repro_torch.utils.tree import flatten_dict, tree_leaves

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class _FakeMesh:
    """Duck-typed mesh: spec() only needs axis_names + devices.shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _mk(shape, names):
    r = LogicalRules.__new__(LogicalRules)
    r.mesh = _FakeMesh(shape, names)
    r.rules = dict(DEFAULT_RULES)
    r.act_overrides = {}
    return r


@pytest.fixture
def group():
    """A process group for the test's own mesh, destroyed after it."""
    yield init_process_group
    destroy_process_group()


# --------------------------------------------------------------------------
# tests/test_sharding.py on the port
# --------------------------------------------------------------------------
def test_weight_fsdp_tp():
    r = _mk((16, 16), ("data", "model"))
    spec = r.spec(("d_model", "d_ff"), (1024, 3072))
    assert spec == P("data", "model")


def test_heads_divisibility_fallback_to_head_dim():
    r = _mk((16, 16), ("data", "model"))
    spec = r.spec(("d_model", "heads", "head_dim"), (5120, 40, 128))
    assert spec == P("data", None, "model")
    spec = r.spec(("d_model", "heads", "head_dim"), (1024, 16, 128))
    assert spec == P("data", "model", None)


def test_priority_heads_over_seq():
    r = _mk((16, 16), ("data", "model"))
    spec = r.spec(("batch", "seq", "heads", "head_dim"), (256, 4096, 16, 128),
                  is_act=True)
    assert spec == P("data", None, "model", None)
    spec = r.spec(("batch", "seq", "d_model"), (256, 4096, 1024), is_act=True)
    assert spec == P("data", "model", None)


def test_batch_pod_data_multiaxis():
    r = _mk((2, 16, 16), ("pod", "data", "model"))
    spec = r.spec(("batch", "seq", "d_model"), (256, 4096, 1024), is_act=True)
    assert spec == P(("pod", "data"), "model", None)


def test_batch_one_falls_back_to_kv_seq():
    r = _mk((16, 16), ("data", "model"))
    spec = r.spec(("batch", "kv_seq", "kv_heads", "head_dim"),
                  (1, 524288, 16, 128), is_act=True)
    assert spec == P(None, "data", "model", None)


def test_moe_expert_fallback():
    r = _mk((16, 16), ("data", "model"))
    spec = r.spec(("experts", "d_model", "moe_d_ff"), (64, 2048, 1408))
    assert spec == P("model", "data", None)
    spec = r.spec(("experts", "d_model", "moe_d_ff"), (8, 6144, 16384))
    assert spec == P(None, "data", "model")


def test_axis_never_reused_within_spec():
    r = _mk((16, 16), ("data", "model"))
    for names, shape in [
        (("vocab", "d_ff"), (151936, 3072)),
        (("heads", "d_ff", "seq"), (16, 3072, 4096)),
    ]:
        spec = r.spec(names, shape)
        used = [a for part in spec if part is not None
                for a in (part if isinstance(part, tuple) else (part,))]
        assert len(used) == len(set(used)), (names, spec)


def test_real_mesh_sharded_jit(group):
    """A real one-rank ``gloo`` mesh: specs degrade to replicated, and
    ``lshard`` redistributes a DTensor (and refuses a plain tensor)."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.sharding.logical import lshard, use_rules
    group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    r = LogicalRules(mesh)
    with use_rules(r):
        x = distribute_tensor(torch.ones((4, 8)), mesh,
                              [Replicate(), Replicate()])
        y = lshard(x * 2, "batch", "d_model")
        assert isinstance(y, DTensor)
        with pytest.raises(TypeError, match="plain tensor"):
            lshard(torch.ones(4, 8), "batch", "d_model")
    np.testing.assert_array_equal(y.full_tensor().numpy(), 2 * np.ones((4, 8)))


def test_spec_equals_jax_partition_spec():
    """The port's spec type is equal, entry by entry, to JAX's."""
    assert P("data", None, ("pod", "data")) == JP("data", None, ("pod", "data"))
    assert tuple(P()) == tuple(JP()) == ()
    assert isinstance(P("a"), PartitionSpec)


# --------------------------------------------------------------------------
# placements and meshes
# --------------------------------------------------------------------------
def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert spec_placements(P(("pod", "data"), "model", None), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert spec_placements(P(None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        spec_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        spec_placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in mesh"):
        spec_placements(P("expert"), mesh)


def test_fake_process_group_production_meshes(group):
    """The fake backend (an internal module of torch) gives the production
    meshes in one process; a DeviceMesh gives the duck-typed mesh's specs,
    and a meta DTensor of a spec holds rank 0's shard."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert FakeStore is not None
    for multi_pod, world in ((False, 256), (True, 512)):
        group("fake", world)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        shape, axes = MESHES["2x16x16" if multi_pod else "16x16"]
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
        real, duck = LogicalRules(mesh), _mk(shape, axes)
        for names, shp in [(("batch", "seq", "d_model"), (256, 4096, 1024)),
                           (("d_model", "heads", "head_dim"), (5120, 40, 128))]:
            assert real.spec(names, shp, is_act=True) == \
                duck.spec(names, shp, is_act=True)
        t = tlayers.abstract_leaf((256, 4096, 1024), torch.bfloat16,
                                  real.sharding(("batch", "seq", "d_model"),
                                                (256, 4096, 1024), is_act=True))
        assert tuple(t.to_local().shape) == (
            (8, 256, 1024) if multi_pod else (16, 256, 1024))
        assert t.to_local().device.type == "meta"
        destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((2, 2), ("data", "model"), device_type="cpu")
    group("fake", 8)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("data", "model"), device_type="cpu")


@pytest.mark.parametrize("entry", ["make_mesh", "make_production_mesh",
                                   "surviving_mesh"])
def test_mesh_entry_points_default_to_the_card(group, monkeypatch, entry):
    """A mesh is on the card unless the caller asks for the CPU: without a
    card the default raises and builds no CPU mesh."""
    from repro_torch.train.fault_tolerance import surviving_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, world = {
        "make_mesh": (lambda: make_mesh((1, 1), ("data", "model")), 1),
        "make_production_mesh": (make_production_mesh, 256),
        "surviving_mesh": (lambda: surviving_mesh(0), 1),
    }[entry]
    group("fake", world)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# --------------------------------------------------------------------------
# every param leaf and every cell's inputs, against the JAX package
# --------------------------------------------------------------------------
_JAX_SPECS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import ARCHS
from repro.launch.dryrun import runnable_cells
from repro.launch.mesh import make_mesh
from repro.launch.specs import input_specs
from repro.models.registry import build_model
from repro.sharding.logical import LogicalRules
from repro.train.step import abstract_params

def canon(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]

def flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): canon(leaf.sharding.spec)
            for path, leaf in leaves if getattr(leaf, "sharding", None)}

out = {}
for name, (shape, axes) in json.loads(sys.argv[1]).items():
    rules = LogicalRules(make_mesh(shape, axes))
    params = {a: flat(abstract_params(build_model(cfg), rules))
              for a, cfg in ARCHS.items()}
    inputs = {}
    for a, s in runnable_cells():
        specs = input_specs(build_model(ARCHS[a]), s, rules)
        specs.pop("pos", None)
        inputs[a + "/" + s] = flat(specs)
    out[name] = {"params": params, "inputs": inputs}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    """The JAX package's specs of every param leaf and every cell's inputs
    on both production meshes, from its own meshes of 256/512 devices."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SPECS,
                        json.dumps(MESHES)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


def _canon(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


@pytest.fixture
def spec_leaves(monkeypatch):
    """Abstract leaves as (shape, spec) records: the port's specs without a
    process group."""
    def leaf(shape, dtype, sharding=None):
        return _canon(sharding.spec) if sharding is not None else None
    monkeypatch.setattr(tlayers, "abstract_leaf", leaf)
    monkeypatch.setattr(tspecs, "abstract_leaf", leaf)
    monkeypatch.setattr(tstep, "abstract_leaf", leaf)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(jax_specs, spec_leaves, arch, mesh):
    rules = _mk(*MESHES[mesh])
    got = flatten_dict(abstract_params(build_model(ARCHS[arch]), rules))
    assert got == jax_specs[mesh]["params"][arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_specs_match_jax(jax_specs, spec_leaves, mesh):
    """Every runnable cell's batch (and cache, for decode) names, as
    activations."""
    rules = _mk(*MESHES[mesh])
    want = jax_specs[mesh]["inputs"]
    assert len(want) == len(dryrun.runnable_cells()) == 34
    for arch, shape in dryrun.runnable_cells():
        specs = tspecs.input_specs(build_model(ARCHS[arch]), shape, rules)
        assert specs.pop("pos", SHAPES[shape].seq_len - 1) == \
            SHAPES[shape].seq_len - 1
        got = {k: v for k, v in flatten_dict(specs).items() if v is not None}
        assert got == want[f"{arch}/{shape}"], (arch, shape)


def test_abstract_opt_state_mirrors_params(spec_leaves):
    rules = _mk(*MESHES["16x16"])
    model = build_model(ARCHS["qwen3-0.6b"])
    st = abstract_opt_state(model, rules)
    assert st["step"] == [] and st["mu"] == abstract_params(model, rules)


# --------------------------------------------------------------------------
# the elastic re-mesh: a JAX checkpoint restored onto a one-rank mesh
# --------------------------------------------------------------------------
def test_surviving_mesh_and_elastic_restore(tmp_path, group):
    """The JAX package saves smoke Qwen3's params; the port's
    ``elastic_remesh`` restores them onto ``surviving_mesh(0)`` (a one-rank
    CPU mesh) as DTensors of the rules' placements, equal by bits."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.fault_tolerance import (elastic_remesh,
                                                   surviving_mesh)
    params = j_build_model(J_SMOKE["qwen3-0.6b"]).init(jax.random.PRNGKey(0))
    JCheckpointManager(str(tmp_path)).save(1, params)
    group("gloo")
    model = build_model(SMOKE_ARCHS["qwen3-0.6b"])
    mesh = surviving_mesh(0, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)
    restored, step = elastic_remesh(CheckpointManager(str(tmp_path)),
                                    abstract_params(model), mesh,
                                    model.logical_names())
    assert step == 1
    rules = LogicalRules(mesh)
    names = flatten_dict(model.logical_names())
    want_flat = flatten_dict(params)
    assert sorted(want_flat) == sorted(flatten_dict(restored))
    for k, got in flatten_dict(restored).items():
        want = want_flat[k]
        assert isinstance(got, DTensor) and got.device.type == "cpu"
        assert list(got.placements) == \
            rules.sharding(names[k], got.shape).placements()
        np.testing.assert_array_equal(got.full_tensor().numpy(),
                                      np.asarray(want))
    # without a sharding tree, plain tensors, as before
    plain, _ = CheckpointManager(str(tmp_path)).restore(
        abstract_params(model))
    assert not any(isinstance(t, DTensor) for t in tree_leaves(plain))


# --------------------------------------------------------------------------
# a real four-rank mesh: the sharded loss and gradients equal the plain ones
# --------------------------------------------------------------------------
_FOUR_RANKS = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.sharding.logical import LogicalRules, use_rules
from repro_torch.train.step import compute_params, loss_and_grads
from repro_torch.utils.tree import flatten_dict, tree_map

arch, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
cfg = SMOKE_ARCHS[arch].replace(dtype="float32")
model = build_model(cfg)
params = model.init(torch.Generator().manual_seed(0), "cpu")
toks = torch.as_tensor(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (4, 17)), dtype=torch.int32)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
loss, _, grads = loss_and_grads(model, compute_params(params, torch.float32),
                                batch)
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
rules = LogicalRules(mesh)
dparams = tree_map(lambda t, n: distribute_tensor(
    t, mesh, rules.sharding(n, t.shape).placements(), src_data_rank=None),
    params, model.logical_names())
with use_rules(rules):
    dloss, _, dgrads = loss_and_grads(
        model, compute_params(dparams, torch.float32), batch)
if isinstance(dloss, DTensor):
    dloss = dloss.full_tensor()
want, got = flatten_dict(grads), flatten_dict(dgrads)
sharded = sum(any(p.is_shard() for p in g.placements) for g in got.values())
err = {k: float((want[k] - g.full_tensor()).abs().max()
                / want[k].abs().max().clamp_min(1e-30))
       for k, g in got.items()}
if rank == 0:
    print(json.dumps({"loss": float(loss), "dloss": float(dloss),
                      "sharded": sharded, "leaves": len(got),
                      "grad_err": max(err.values())}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-27b",
                                  "recurrentgemma-9b", "moonshot-v1-16b-a3b",
                                  "mixtral-8x22b", "rwkv6-1.6b"])
def test_sharded_loss_and_grads_on_four_gloo_ranks(tmp_path, arch):
    """Smoke configs in f32 on a (2, 2) mesh of four ``gloo`` processes:
    the loss and every gradient under the rules (weights gathered for
    their products, the vocab-parallel lookup, gold logit and logsumexp,
    gradients held to the activations' placements) equal the unsharded
    ones within 1e-6 (loss) and 1e-5 of each leaf's largest |gradient|:
    the sums are split across ranks, so the order of addition differs."""
    script = tmp_path / "four_ranks.py"
    script.write_text(_FOUR_RANKS)
    port = str(tmesh._free_port())
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), arch, str(r),
                               port], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["sharded"] > 0, res
    assert abs(res["dloss"] - res["loss"]) <= 1e-6 * abs(res["loss"]), res
    assert res["grad_err"] <= 1e-5, res
