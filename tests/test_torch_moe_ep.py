"""The port's expert-parallel MoE against its single-device ``moe`` and
against the JAX package's expert-parallel path.

Under ``mesh_context`` on a 2 x 2 grid of the CPU device the port's
``moe`` must take the branch the JAX layer takes (the weights-stationary
dispatch at n = 32 tokens, the shard-map dispatch at n = 2,208 > 2,048),
for reduced qwen3-moe (softmax router) and deepseek-v3 (sigmoid router
and a shared expert).  Forward and the gradients of ``router``, ``wi`` and
``wo`` of ``sum(y**2)`` are held, with the bounds of
``tests/test_moe_ep.py`` (forward 1e-4 absolute, gradients 1e-5 relative
to the largest), against:

* the port's single-device ``moe``, on inputs where neither dispatch
  drops a token (the EP capacity is per expert and data shard, rounded to
  8; the single-device one rounded to 128 plus a spill), which is
  checked;
* JAX's EP path on an Auto-axes 2 x 2 mesh, on the same inputs and on
  identical tokens, where both EP branches drop assignments and only JAX's
  EP is the reference.

JAX's side runs once, in one subprocess with 4 CPU devices.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.sharding import mesh_context

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
#: (batch, length) of each input: 32 tokens (stationary), 2,208 (shard-map)
SHAPES = {"n32": (4, 8), "n2208": (4, 552)}
WANT_BRANCH = {"n32": "stationary", "n2208": "shardmap"}
FWD_TOL, GRAD_RTOL = 1e-4, 1e-5

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: on a loaded machine
    (the suite's other workers) a parallel region waits on its slowest
    thread, which can stretch each small op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_EP = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import layers as L
from repro.sharding import mesh_context

archs, shapes, out_npz = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    sys.argv[3]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
taken = []
for name in ("_moe_ep_stationary", "_moe_ep_shardmap"):
    def wrap(*a, _f=getattr(L, name), _n=name, **k):
        taken.append(_n[len("_moe_ep_"):])
        return _f(*a, **k)
    setattr(L, name, wrap)

def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

out, branch = {}, {}
for arch in archs:
    cfg = get_config(arch, reduced=True)
    params = L.init_moe(cfg, jax.random.PRNGKey(0))
    out.update(flat(params, f"{arch}/params/"))

    def loss(p, x):
        y = L.moe(cfg, p, x)
        return (y ** 2).sum(), y

    for name, shape in shapes.items():
        x = jax.random.normal(jax.random.PRNGKey(1),
                              tuple(shape) + (cfg.d_model,))
        for case, xx in ((name, x),
                         (name + "-same", jnp.broadcast_to(
                             x[:1, :1], x.shape))):
            taken.clear()
            with mesh_context(mesh):
                (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                    params, xx)
            branch[f"{arch}/{case}"] = list(taken)
            out[f"{arch}/{case}/x"] = np.asarray(xx)
            out[f"{arch}/{case}/y"] = np.asarray(y)
            out.update(flat(g, f"{arch}/{case}/grad/"))
np.savez(out_npz, **out)
print(json.dumps(branch))
'''


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    npz = tmp_path_factory.mktemp("moe_ep") / "jax_ep.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _JAX_EP, json.dumps(ARCHS),
                        json.dumps(SHAPES), str(npz)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(r.stdout.strip().splitlines()[-1])


def params_of(arrays, arch):
    p = {}
    prefix = f"{arch}/params/"
    for k, v in arrays.items():
        if k.startswith(prefix):
            *outer, leaf = k[len(prefix):].split("/")
            d = p
            for o in outer:
                d = d.setdefault(o, {})
            d[leaf] = torch.from_numpy(v.copy())
    return p


def run(cfg, params, x, mesh=None):
    """(y, grads of router / wi / wo) of ``sum(moe(x)**2)``, and the EP
    branches taken."""
    p = {k: (v.clone().requires_grad_(True) if isinstance(v, torch.Tensor)
             else v) for k, v in params.items()}
    taken = []
    orig = {n: getattr(L, n) for n in ("_moe_ep_stationary",
                                       "_moe_ep_shardmap")}

    def wrap(name):
        def f(*a, **k):
            taken.append(name[len("_moe_ep_"):])
            return orig[name](*a, **k)
        return f
    try:
        for n in orig:
            setattr(L, n, wrap(n))
        if mesh is None:
            y = L.moe(cfg, p, x)
        else:
            with mesh_context(mesh):
                y = L.moe(cfg, p, x)
    finally:
        for n, f in orig.items():
            setattr(L, n, f)
    (y ** 2).sum().backward()
    return y.detach(), {k: p[k].grad for k in ("router", "wi", "wo")}, taken


def close(y, g, y_ref, g_ref):
    assert float((y - y_ref).abs().max()) < FWD_TOL
    for k in ("router", "wi", "wo"):
        d = float((g[k] - g_ref[k]).abs().max())
        s = float(g_ref[k].abs().max()) + 1e-9
        assert d / s < GRAD_RTOL, (k, d, s)


def drops(cfg, router, x2, shards):
    n = x2.shape[0]
    return L.dropped_assignments(cfg, router, x2, shards,
                                 L._ep_capacity(cfg, n // shards))


@pytest.fixture(scope="module")
def grid():
    return make_host_mesh(2, devices=["cpu"] * 4)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_takes_the_reference_branch_and_matches_both(jax_ep, grid, arch,
                                                        shape):
    arrays, branch = jax_ep
    cfg = get_config(arch, reduced=True)
    params = params_of(arrays, arch)
    x = torch.from_numpy(arrays[f"{arch}/{shape}/x"])
    y, g, taken = run(cfg, params, x, grid)
    assert taken == branch[f"{arch}/{shape}"] == [WANT_BRANCH[shape]]
    # neither dispatch drops a token on these inputs
    x2 = x.reshape(-1, cfg.d_model)
    shards = 1 if shape == "n32" else 2
    assert drops(cfg, params["router"], x2, shards) == 0
    assert L.dropped_assignments(cfg, params["router"], x2, 1,
                                 L._moe_capacity(cfg, x2.shape[0])) == 0
    y1, g1, none = run(cfg, params, x)
    assert none == []
    close(y, g, y1, g1)
    jy = torch.from_numpy(arrays[f"{arch}/{shape}/y"])
    jg = {k: torch.from_numpy(arrays[f"{arch}/{shape}/grad/{k}"])
          for k in ("router", "wi", "wo")}
    close(y, g, jy, jg)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dropping_tokens_matches_jax_ep(jax_ep, grid, arch, shape):
    """Identical tokens all pick the same k experts: the EP capacity drops
    assignments (per data shard in the shard-map branch), as JAX's EP
    does, so the output differs from the single-device path's."""
    arrays, branch = jax_ep
    cfg = get_config(arch, reduced=True)
    params = params_of(arrays, arch)
    case = f"{shape}-same"
    x = torch.from_numpy(arrays[f"{arch}/{case}/x"])
    y, g, taken = run(cfg, params, x, grid)
    assert taken == branch[f"{arch}/{case}"] == [WANT_BRANCH[shape]]
    x2 = x.reshape(-1, cfg.d_model)
    assert drops(cfg, params["router"], x2,
                 1 if shape == "n32" else 2) > 0
    jy = torch.from_numpy(arrays[f"{arch}/{case}/y"])
    jg = {k: torch.from_numpy(arrays[f"{arch}/{case}/grad/{k}"])
          for k in ("router", "wi", "wo")}
    close(y, g, jy, jg)
    y1, _, _ = run(cfg, params, x)
    assert float((y - y1).abs().max()) > FWD_TOL


def test_branch_choice_follows_the_mesh(grid):
    """The JAX layer's rules: no mesh, no ``"model"`` axis or experts that
    do not divide it → single device; n > 2,048 tokens not divisible by
    the dp size → single device; no ``"data"`` axis → shard-map; the
    stationary path needs ``"data"`` to divide d_model and d_expert."""
    from repro_torch.launch.mesh import FilterMesh
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    params = L.init_moe(cfg, torch.Generator().manual_seed(0))
    cases = [
        (None, (1, 6), []),
        (FilterMesh([["cpu"] * 3], ("data", "model")), (1, 6), []),
        (FilterMesh(["cpu"] * 2, ("data",)), (1, 6), []),
        (FilterMesh(["cpu"] * 2, ("model",)), (1, 6), ["shardmap"]),
        (grid, (1, 6), ["stationary"]),
        (grid, (1, 2049), []),
        (grid, (1, 2050), ["shardmap"]),
        (FilterMesh([["cpu"] * 2] * 3, ("data", "model")), (1, 6),
         ["shardmap"]),
    ]
    for mesh, shape, want in cases:
        xx = torch.randn(shape + (cfg.d_model,),
                         generator=torch.Generator().manual_seed(2))
        _, _, taken = run(cfg, params, xx, mesh)
        assert taken == want, (mesh and mesh.shape, shape, taken)


def test_streams_off_is_the_same_arithmetic(grid):
    """``streams=False`` (positions one after another on the caller's
    stream) is the same computation as the default; on the CPU both run
    in order, so they agree bit for bit."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0))
    x2 = torch.randn(32, cfg.d_model, generator=torch.Generator()
                     .manual_seed(3))
    for f in (L._moe_ep_stationary, L._moe_ep_shardmap):
        assert torch.equal(f(cfg, p, x2, grid), f(cfg, p, x2, grid,
                                                  streams=False))


def branch_log(monkeypatch) -> list:
    """Log each ``moe`` dispatch taken: ``"stationary"``, ``"shardmap"``
    or ``"single"``."""
    taken: list = []
    for name in ("_moe_ep_stationary", "_moe_ep_shardmap", "_moe_single"):
        def wrap(*a, _f=getattr(L, name), _n=name.split("_")[-1], **k):
            taken.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(L, name, wrap)
    return taken


@pytest.mark.parametrize("shape", list(SHAPES))
def test_remat_recomputes_under_the_forwards_mesh(grid, monkeypatch, shape):
    """Reduced qwen3-moe's ``train_loss`` recorded under ``mesh_context``
    with ``remat=True`` and differentiated after the context has closed
    (as autograd's own thread on a card sees no active mesh): each
    layer's recompute takes the forward's expert-parallel branch, and the
    gradients equal those of ``remat=False`` inside the context, within
    the bounds of ``tests/test_moe_ep.py``."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, SHAPES[shape][:1] + (
        SHAPES[shape][1] + 1,)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    taken = branch_log(monkeypatch)
    runs = {}
    for remat in (True, False):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        taken.clear()
        with mesh_context(grid):
            loss, _ = T.train_loss(cfg.with_(remat=remat), p, batch)
            if not remat:
                grads = torch.autograd.grad(loss, leaves)
        if remat:
            grads = torch.autograd.grad(loss, leaves)
        runs[remat] = (float(loss.detach()), grads, list(taken))
    want = [WANT_BRANCH[shape]] * cfg.n_layers
    assert runs[False][2] == want
    assert runs[True][2] == want * 2          # forward, then recompute
    assert abs(runs[True][0] - runs[False][0]) < FWD_TOL
    for a, b in zip(runs[True][1], runs[False][1]):
        d = float((a - b).abs().max())
        assert d / (float(b.abs().max()) + 1e-9) < GRAD_RTOL, d
