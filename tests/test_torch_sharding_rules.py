"""The port's sharding rules and mesh context against the JAX package's.

``repro_torch.sharding.rules`` over the port's trees (shapes from
``init_model(cfg, None)``'s meta tensors and ``init_cache(...,
device="meta")``) must give JAX's ``PartitionSpec`` entry for entry:
``param_specs`` and ``cache_specs`` for every architecture, reduced and
at full size, and ``batch_specs`` and ``logits_spec``, at meshes (1, 1),
(2, 2) and (4, 2) and a (2, 2, 2) mesh with a ``"pod"`` axis.  The JAX
side runs once, in one subprocess with
``--xla_force_host_platform_device_count=8`` and Auto axes (the installed
JAX makes Explicit axes by default; the rules only read the mesh's shape
and names).  Also held: ``mesh_context`` / ``spec`` / ``axis_size`` against
JAX's ``repro.sharding.ctx``, ``constrain`` as the identity, the spec
type's canonical entries, and ``make_host_mesh`` /
``make_production_mesh``.
"""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import (FilterMesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as T
from repro_torch.sharding import ctx, rules as R
from repro_torch.sharding.placement import NamedSharding
from repro_torch.tree import key_of, tree_flatten_with_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: (data, model) meshes, then the one with a pod axis
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: batch shapes: dividing every dp size, dividing none, and B = 1
BATCHES = {"b8": {"tokens": (8, 128), "labels": (8, 128),
                  "frames": (8, 16, 32)},
           "b3": {"tokens": (3, 64), "labels": (3, 64)},
           "b1": {"tokens": (1, 32)}}
#: (batch, max_len) of the caches: batch-sharded, and context-parallel
CACHES = ((8, 64), (1, 64))

_JAX_SPECS = r'''
import json, sys
import jax
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import ARCHS, get_config
from repro.models import transformer as T
from repro.sharding import rules as R
from repro.sharding.ctx import axis_size, mesh_context, spec

meshes, batches, caches = json.loads(sys.argv[1])

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {key(p): list(map(lambda e: list(e) if isinstance(e, tuple)
                             else e, s)) for p, s in leaves}

out = {"params": {}, "batch": {}, "cache": {}, "logits": {}, "ctx": {}}
shapes = {}
for arch in ARCHS:
    for reduced in (True, False):
        cfg = get_config(arch, reduced=reduced)
        shapes[arch, reduced] = (cfg, jax.eval_shape(
            lambda c=cfg: T.init_model(c, jax.random.PRNGKey(0))))
cache_shapes = {}
for arch in ARCHS:
    for reduced in (True, False):
        cfg = get_config(arch, reduced=reduced)
        for b, l in caches:
            cache_shapes[arch, reduced, b] = (cfg, jax.eval_shape(
                lambda c=cfg, b=b, l=l: T.init_cache(c, b, l)))
for name, (shape, axes) in meshes.items():
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes))
    for (arch, reduced), (cfg, sh) in shapes.items():
        out["params"][f"{name}:{arch}:{int(reduced)}"] = flat(
            R.param_specs(cfg, sh, mesh))
    cfg = get_config("qwen3-0.6b", reduced=True)
    for bname, b in batches.items():
        bs = {k: jax.ShapeDtypeStruct(tuple(v), "int32")
              for k, v in b.items()}
        out["batch"][f"{name}:{bname}"] = flat(R.batch_specs(cfg, bs, mesh))
    for (arch, reduced, b), (cfg, sh) in cache_shapes.items():
        out["cache"][f"{name}:{arch}:{int(reduced)}:{b}"] = flat(
            R.cache_specs(cfg, sh, mesh))
    out["logits"][name] = flat({"l": R.logits_spec(mesh)})["l"]
    with mesh_context(mesh):
        out["ctx"][name] = {
            "spec": flat({"s": spec("dp", None, "model", ("pod", "data"),
                                    ("model", "absent"), "absent")})["s"],
            "axis_size": [axis_size(a) for a in
                          ("dp", "data", "model", "pod", "absent")]}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    arg = json.dumps([MESHES, BATCHES, CACHES])
    out = subprocess.run([sys.executable, "-c", _JAX_SPECS, arg], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_mesh(name):
    shape, axes = MESHES[name]

    def grid(dims):
        return "cpu" if not dims else [grid(dims[1:]) for _ in range(dims[0])]
    return FilterMesh(grid(shape), axis_names=axes)


def as_lists(tree):
    """A spec tree as ``{key: [entry, ...]}`` with tuple entries as lists
    (JSON's spelling of JAX's)."""
    return {key_of(p): [list(e) if isinstance(e, tuple) else e for e in s]
            for p, s in tree_flatten_with_path(tree, is_leaf=R.is_spec)}


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(jax_specs, arch, reduced, mesh):
    cfg = get_config(arch, reduced=reduced)
    specs = R.param_specs(cfg, T.init_model(cfg, None), port_mesh(mesh))
    assert all(isinstance(s, R.PartitionSpec)
               for _, s in tree_flatten_with_path(specs, is_leaf=R.is_spec))
    got = as_lists(specs)
    assert got == jax_specs["params"][f"{mesh}:{arch}:{int(reduced)}"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_shardings_cut_leaves_on_a_wide_mesh(mesh):
    """Not every spec degrades to replication: on a mesh wider than 1 x 1
    the full-size qwen3-0.6b's shardings cut most of its leaves; on 1 x 1
    none, though the specs still name the axes (as JAX's do)."""
    cfg = get_config("qwen3-0.6b")
    sh = R.param_shardings(cfg, T.init_model(cfg, None), port_mesh(mesh))
    leaves = [s for _, s in tree_flatten_with_path(sh)]
    assert all(isinstance(s, NamedSharding) for s in leaves)
    cut = [s for s in leaves if not s.is_fully_replicated]
    assert (len(cut) > len(leaves) // 2) == (mesh != "1x1")
    assert sh["embed"].spec == ("model", "data")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", list(BATCHES))
def test_batch_specs_equal_jax(jax_specs, batch, mesh):
    cfg = get_config("qwen3-0.6b", reduced=True)
    shapes = {k: _Shape(v) for k, v in BATCHES[batch].items()}
    got = as_lists(R.batch_specs(cfg, shapes, port_mesh(mesh)))
    assert got == jax_specs["batch"][f"{mesh}:{batch}"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(jax_specs, arch, reduced, mesh):
    cfg = get_config(arch, reduced=reduced)
    for b, l in CACHES:
        caches = T.init_cache(cfg, b, l, device="meta")
        got = as_lists(R.cache_specs(cfg, caches, port_mesh(mesh)))
        want = jax_specs["cache"][f"{mesh}:{arch}:{int(reduced)}:{b}"]
        assert got == want, b


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logits_spec_and_ctx_equal_jax(jax_specs, mesh):
    m = port_mesh(mesh)
    got = [list(e) if isinstance(e, tuple) else e for e in R.logits_spec(m)]
    assert got == jax_specs["logits"][mesh]
    assert ctx._mesh() is None
    with ctx.mesh_context(m) as active:
        assert active is m and ctx._mesh() is m
        s = ctx.spec("dp", None, "model", ("pod", "data"),
                     ("model", "absent"), "absent")
        assert [list(e) if isinstance(e, tuple) else e for e in s] \
            == jax_specs["ctx"][mesh]["spec"]
        assert [ctx.axis_size(a) for a in
                ("dp", "data", "model", "pod", "absent")] \
            == jax_specs["ctx"][mesh]["axis_size"]
    assert ctx._mesh() is None


def test_ctx_outside_a_mesh_and_per_thread():
    """Outside a context: ``spec()`` is the empty spec, ``axis_size`` its
    default, ``constrain`` the identity (as everywhere).  The context is
    the calling thread's, and nests."""
    x = torch.arange(6.0).reshape(2, 3)
    assert ctx.spec("data", "model") == R.PartitionSpec() == ()
    assert ctx.axis_size("model") == 1 and ctx.axis_size("dp", 5) == 5
    assert ctx.constrain(x, ("dp", "model")) is x
    outer, inner = port_mesh("2x2"), port_mesh("4x2")
    seen = []
    with ctx.mesh_context(outer):
        with ctx.mesh_context(inner):
            assert ctx.axis_size("data") == 4
            assert ctx.constrain(x, ("dp", "model")) is x
            t = threading.Thread(target=lambda: seen.append(ctx._mesh()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert ctx._mesh() is outer
    assert seen == [None] and ctx._mesh() is None


def test_spec_type_keeps_jax_entries():
    P = R.PartitionSpec
    assert tuple(P(("data",), None, ["pod", "data"], (), "model")) == (
        "data", None, ("pod", "data"), None, "model")
    assert isinstance(P("data"), tuple) and P("data") == ("data",)
    mesh = port_mesh("2x2x2")
    # absent or non-dividing axes drop; a tuple axis stays a tuple
    assert R.sanitize((("pod", "data"), "model", "absent"), (8, 3, 4),
                      mesh) == (("pod", "data"), None, None)
    assert R.sanitize(("data",), (), mesh) == ()
    assert R.sanitize(("model",), (5, 6), mesh) == (None, "model")


def test_make_host_mesh_and_its_errors(monkeypatch):
    m = make_host_mesh(2, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.axis_names == (
        "data", "model")
    assert make_host_mesh(devices=["cpu"] * 3).shape == {"data": 3,
                                                          "model": 1}
    for bad in (0, -1, 3):
        with pytest.raises(ValueError, match="not divisible by model"):
            make_host_mesh(bad, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_host_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = make_host_mesh(2)
    assert cards.shape == {"data": 2, "model": 2}
    assert [d.index for d in cards.devices] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="4 devices not divisible"):
        make_host_mesh(3)


def test_production_meshes_are_shapes_on_meta():
    one = make_production_mesh()
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    pods = make_production_mesh(multi_pod=True)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert pods.size == 512
    assert {d.type for d in pods.devices} == {"meta"}
    cfg = get_config("deepseek-v3-671b")
    specs = R.param_specs(cfg, T.init_model(cfg, None), pods)
    assert specs["embed"] == ("model", "data")
    assert R.logits_spec(pods) == (("pod", "data"), None, "model")
