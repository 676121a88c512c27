"""The port's counterpart of ``launch/hlo_analysis.py``
(``repro_torch.launch.cost_analysis``).

* ``collective_wire_bytes`` equals the JAX module's ring table
  (``_collective_wire_bytes``, which reads an HLO op) for every kind at
  group sizes 1, 2, 4 and 16; the JAX module is plain Python;
* ``TrafficCounterMode`` counts exactly on hand-built functions: a
  product (operands and result), views (nothing), a KV-cache slice write
  (twice the update), a ``cat`` (its parts and its result), a broadcast
  operand (its distinct elements);
* ``CollectiveCounter`` on ``_psum``, ``_pmax`` and ``_all_gather`` over
  2 x 2 and (4, 1) grids of the CPU device gives each position the ring
  bytes of its group's result, keyed by position (every position has the
  same device), and nothing outside a ``with``; autograd's pass back
  through a sum counts an all-reduce, through a gather a reduce-scatter;
* a meta mesh's ``first_position()`` view stands the first position's
  part in for the group's others, and the holders a sharding caches do
  not outlive its mesh;
* ``read_region`` counts the blocks a position does not hold as an
  all-gather and their gradient as a reduce-scatter, and a replicated
  block's gradient as an all-reduce over its holders;
* a meta mesh's ``first_position()`` view counts what the whole mesh's
  mean counts, for a train step (the optimizer update included) and a
  serving step of every family, the context-parallel layout too (the
  dry run counts the production meshes that way);
* the optimizer's folds over blocks held at other positions count one
  all-reduce of the fold's result over the positions whose blocks it
  folds: AdamW's norm over a leaf split two ways, Adafactor's row,
  column, row-mean and update-RMS sums over a leaf split both ways; a
  leaf whose blocks are all at one position moves nothing, and the
  update's results equal the unplaced update's;
* ``analyze_step`` and ``traffic_breakdown`` return ``analyze_text``'s
  and ``traffic_breakdown``'s shapes.

The mini cells' counts against XLA's are in
``tests/test_torch_cells_dryrun.py``, whose JAX subprocess compiles them.
"""
import pytest
import torch

from repro.launch import hlo_analysis as H
from repro_torch.configs import get_config
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.cells import Cell
from repro_torch.launch.mesh import FilterMesh, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import counters
from repro_torch.sharding.placement import (NamedSharding, device_put,
                                            gather, read_region)
from repro_torch.sharding.rules import PartitionSpec as P


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's other workers load the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", C.COLLECTIVES)
def test_ring_table_equals_hlo_analysis(kind, g):
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    for n in (1, 6, 4096):
        op = H.Op("x", f"f32[{n}]", kind, f"%p), replica_groups={groups}")
        assert C.collective_wire_bytes(kind, 4 * n, g) \
            == H._collective_wire_bytes(op)


def traffic(fn) -> tuple[int, dict]:
    with C.TrafficCounterMode() as mode:
        fn()
    return mode.total, mode.by_op


def test_traffic_of_a_product_and_views():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    total, by = traffic(lambda: a @ b)
    assert total == 4 * (8 * 16 + 16 * 4 + 8 * 4) and set(by) == {"mm"}
    total, _ = traffic(lambda: (a.view(2, 64), a[2:5], a.t(), a.reshape(128),
                                a.expand(2, 8, 16), a.unsqueeze(0)))
    assert total == 0


def test_traffic_of_a_kv_cache_write_is_twice_the_update():
    cache = torch.zeros(2, 4, 64, 8)
    new = torch.ones(2, 4, 1, 8)
    total, by = traffic(lambda: cache[:, :, 10:11].copy_(new))
    assert total == 2 * new.numel() * 4 and set(by) == {"copy_"}
    total, _ = traffic(lambda: cache.__setitem__(
        (slice(None), slice(None), slice(3, 4)), new))
    assert total == 2 * new.numel() * 4
    idx, rows = (torch.tensor([0, 1]),), torch.ones(2, 4, 64, 8)
    total, _ = traffic(lambda: cache.index_put_(idx, rows))
    assert total == 2 * rows.numel() * 4


def test_traffic_of_a_cat_a_slice_copy_and_a_broadcast():
    parts = [torch.ones(3, 5), torch.ones(4, 5)]
    total, by = traffic(lambda: torch.cat(parts))
    assert total == 2 * (7 * 5) * 4 and set(by) == {"cat"}
    big = torch.ones(100, 10)
    total, _ = traffic(lambda: big[10:20].clone())       # reads the slice
    assert total == 2 * 10 * 10 * 4
    row = torch.ones(1, 10)
    total, _ = traffic(lambda: big + row.expand(100, 10))
    assert total == (1000 + 10 + 1000) * 4


def grid(shape):
    data, model = shape
    return make_host_mesh(model, devices=["cpu"] * (data * model))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_collectives_count_the_ring_bytes_by_position(shape):
    mesh = grid(shape)
    parts = {idx: torch.full((3, 5), float(i)) for i, idx in
             enumerate(mesh.positions())}
    with C.CollectiveCounter() as c:
        s = L._psum(mesh, parts, ("model",), False)
        m = L._pmax(mesh, parts, ("data",), False)
        g = L._all_gather(mesh, parts, ("data", "model"), 0, False)
    data, model = shape
    b = 3 * 5 * 4
    assert set(c.by_position) == set(mesh.positions())
    for idx in mesh.positions():
        assert c.by_position[idx] == {
            "all-reduce": C.collective_wire_bytes("all-reduce", b, model)
            + C.collective_wire_bytes("all-reduce", b, data),
            "all-gather": C.collective_wire_bytes(
                "all-gather", b * data * model, data * model)}
        assert g[idx].shape == (3 * data * model, 5)
    assert all(t.shape == (3, 5) for t in (*s.values(), *m.values()))
    # nothing is counted with no counter active
    assert counters.ACTIVE is None
    L._psum(mesh, parts, ("model",), False)
    assert set(c.by_position) == set(mesh.positions())


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_backward_of_a_collective_counts_its_transpose(shape):
    """Autograd's pass back through ``_psum`` moves the sum's cotangent
    over the group again (an all-reduce of the result), and back through
    ``_all_gather`` sums and scatters it to the parts (a reduce-scatter
    whose result is one part); a result that takes no gradient counts its
    forward only."""
    mesh = grid(shape)
    data, model = shape
    parts = {idx: torch.full((3, 5), float(i), requires_grad=True)
             for i, idx in enumerate(mesh.positions())}
    b = 3 * 5 * 4
    with C.CollectiveCounter() as c:
        s = L._psum(mesh, parts, ("model",), False)
        g = L._all_gather(mesh, parts, ("data",), 0, False)
        sum(t.sum() for t in (*s.values(), *g.values())).backward()
    for idx in mesh.positions():
        assert c.by_position[idx] == {
            "all-reduce": 2 * C.collective_wire_bytes("all-reduce", b, model),
            "all-gather": C.collective_wire_bytes("all-gather", b * data,
                                                  data),
            "reduce-scatter": C.collective_wire_bytes("reduce-scatter", b,
                                                      data)}
        assert torch.equal(parts[idx].grad,
                           torch.full((3, 5), float(model + data)))
    with C.CollectiveCounter() as c:
        with torch.no_grad():
            L._psum(mesh, parts, ("model",), False)
    assert c.by_position[mesh.positions()[0]] == {
        "all-reduce": C.collective_wire_bytes("all-reduce", b, model)}


def test_first_position_view_stands_in_for_the_group():
    """On a meta mesh's ``first_position()`` view the gather's result has
    the whole group's shape (the other positions' parts stand in with the
    first's), the sum counts at the group's size, and only the first
    position runs."""
    mesh = FilterMesh([["meta"] * 2] * 4).first_position()
    assert mesh.positions() == [(0, 0)] and len(mesh.grid_positions()) == 8
    part = {(0, 0): torch.empty((3, 5), device="meta", requires_grad=True)}
    with C.CollectiveCounter() as c:
        g = L._all_gather(mesh, part, ("data",), 0, False)
        s = L._psum(mesh, part, ("data", "model"), False)
    assert set(g) == set(s) == {(0, 0)}
    assert g[(0, 0)].shape == (12, 5) and s[(0, 0)].shape == (3, 5)
    b = 3 * 5 * 4
    assert c.by_position == {(0, 0): {
        "all-gather": C.collective_wire_bytes("all-gather", 4 * b, 4),
        "all-reduce": C.collective_wire_bytes("all-reduce", b, 8)}}


def test_holders_are_kept_with_the_sharding():
    """The block holders a sharding caches go with it and its mesh: no
    module-level cache keeps a mesh alive."""
    import gc
    import weakref
    from repro_torch.sharding.placement import holders

    mesh = grid((2, 2))
    leaf = device_put({"w": torch.zeros(4, 6)},
                      NamedSharding(mesh, P("data", None)))["w"]
    assert holders(leaf) == {(0, 0): (0, 0), (1, 0): (1, 0)}
    assert holders(leaf) is not holders(leaf)       # a copy each call
    gone = weakref.ref(mesh)
    del mesh, leaf
    gc.collect()
    assert gone() is None


def test_counter_keys_positions_on_one_repeated_device():
    """Four positions on the CPU device: one leaf split over ``"data"``
    and replicated over ``"model"``; each position reads the whole leaf.
    The blocks it does not hold are an all-gather, their gradients a
    reduce-scatter, and its own block's gradient an all-reduce over the
    two positions that hold it."""
    mesh = grid((2, 2))
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    leaf = device_put({"w": w}, NamedSharding(mesh, P("data", None)))["w"]
    live = {b: leaf.shards[i].detach().requires_grad_()
            for b, i in {(0, 0): (0, 0), (1, 0): (1, 0)}.items()}
    with C.CollectiveCounter() as c:
        total = sum(read_region(leaf, (slice(None),), torch.device("cpu"),
                                live, position=idx).sum()
                    for idx in mesh.positions())
        total.backward()
    block = 4 * 6 * 4
    for idx in mesh.positions():
        assert c.by_position[idx] == {
            "all-gather": float(block), "reduce-scatter": float(block),
            "all-reduce": C.collective_wire_bytes("all-reduce", block, 2)}
    for t in live.values():
        assert torch.equal(t.grad, torch.full((4, 6), 4.0))


def tiny(arch: str):
    return get_config(arch, reduced=True).with_(
        param_dtype="bfloat16", activ_dtype="bfloat16", pad_heads_to=2,
        remat=True, grad_accum=1, attn_chunk=16, ce_chunk=32)


@pytest.mark.parametrize("arch,kind,rows", [
    ("qwen3-0.6b", "train", 8), ("qwen3-moe-30b-a3b", "train", 8),
    ("deepseek-v3-671b", "train", 8),
    ("qwen3-0.6b", "prefill", 8), ("deepseek-v3-671b", "decode", 8),
    ("qwen3-moe-30b-a3b", "decode", 8), ("internvl2-76b", "prefill", 8),
    ("mamba2-780m", "decode", 8), ("zamba2-7b", "prefill", 8),
    ("whisper-large-v3", "prefill", 8), ("whisper-large-v3", "decode", 8),
    ("zamba2-7b", "decode", 1), ("mamba2-780m", "decode", 1)])
def test_first_position_counts_the_whole_mesh(monkeypatch, arch, kind,
                                              rows):
    """The dry run's view of a meta mesh from its first position gives the
    collective bytes of each kind that the mean over all its positions
    gives; a serving step's accessed bytes too (a train step's differ by
    the gradient sums autograd makes across positions).  One row: the
    context-parallel layout, where only the positions holding the decode
    step's time block write its keys and values, so the first position's
    accessed bytes differ from the mean by their share of those writes."""
    mesh = FilterMesh([["meta"] * 2] * 4)
    cell = Cell(arch, ShapeSpec("mini", 64, rows, kind), True)
    one = D.partitioned_counts(cell, mesh, tiny(arch))
    monkeypatch.setattr(FilterMesh, "first_position", lambda self: self)
    every = D.partitioned_counts(cell, mesh, tiny(arch))
    assert one["collective_breakdown"] == every["collective_breakdown"]
    assert one["collective_bytes_per_device"] > 0
    if kind != "train" and rows % 4 == 0:
        assert one["traffic_bytes_per_device"] \
            == every["traffic_bytes_per_device"]
        assert one["flops_per_device"] == every["flops_per_device"]
    elif kind != "train":
        assert one["traffic_bytes_per_device"] == pytest.approx(
            every["traffic_bytes_per_device"], rel=0.01)
        assert one["flops_per_device"] == every["flops_per_device"]
    else:
        assert one["traffic_bytes_per_device"] == pytest.approx(
            every["traffic_bytes_per_device"], rel=0.05)


def test_analyze_step_and_traffic_breakdown_shapes():
    mesh = grid((2, 2))
    parts = {idx: torch.ones(2, 3) for idx in mesh.positions()}
    w = torch.ones(3, 4)

    def step():
        y = L._psum(mesh, parts, ("model",), False)
        return {i: t @ w for i, t in y.items()}

    got = C.analyze_step(step, mesh)
    assert set(got) == {"flops_per_device", "traffic_bytes_per_device",
                        "collective_bytes_per_device",
                        "collective_breakdown"}
    assert got["flops_per_device"] == 2 * 2 * 3 * 4
    wire = C.collective_wire_bytes("all-reduce", 24, 2)
    assert got["collective_breakdown"] == {"all-reduce": wire}
    assert got["collective_bytes_per_device"] == wire
    # each position's product, and the sum's result at each position
    assert got["traffic_bytes_per_device"] == (2 * 3 + 3 * 4 + 2 * 4) * 4 \
        + 24
    rows = C.traffic_breakdown(step, top=5)
    assert [k for k, _ in rows] == ["mm", "collective"]
    assert rows[0][1] == 4 * (2 * 3 + 3 * 4 + 2 * 4) * 4


def _placed(mesh, spec, t):
    return device_put({"w": t}, NamedSharding(mesh, spec))["w"]


@pytest.mark.parametrize("spec,g", [(P("data", None), 2),
                                    (P("data", "model"), 4), (P(), 1)])
def test_adamw_norm_counts_a_fold_over_the_blocks(spec, g):
    """AdamW's clip takes the gradients' global norm: a leaf cut into ``g``
    blocks folds its blocks' square sums, a float32 scalar all-reduced
    over the ``g`` positions holding them; a leaf whose every block is at
    one position moves nothing.  The update equals the unplaced one."""
    from repro_torch.train.optimizer import make_adamw

    mesh = grid((2, 2))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 6, generator=gen)
    grad = torch.randn(8, 6, generator=gen)
    opt = make_adamw()
    plain = {"w": w.clone()}
    plain_state = opt.init(plain)
    opt.update({"w": grad}, plain_state, plain, 0)
    params = {"w": _placed(mesh, spec, w)}
    state = {k: [_placed(mesh, spec, torch.zeros(8, 6))] for k in "mv"}
    with C.CollectiveCounter() as c:
        opt.update({"w": _placed(mesh, spec, grad)}, state, params, 0)
    want = C.collective_wire_bytes("all-reduce", 4, g)
    for idx in mesh.positions():
        assert c.by_position.get(idx, {}) == (
            {"all-reduce": want} if g > 1 else {})
    assert torch.equal(gather(params["w"]), plain["w"])


def test_adafactor_counts_its_factored_folds():
    """Adafactor on a (8, 6) leaf split over ``"data"`` on its rows and
    ``"model"`` on its columns: the row sums fold the 2 column blocks
    (a (4,) float32 result), the column sums the 2 row blocks ((3,)), the
    row statistic's mean the 2 row blocks (a scalar) and the update's
    RMS all 4 blocks (a scalar); each an all-reduce a position.  A
    (8,) leaf split over ``"data"``: its update's RMS only.  The update
    equals the unplaced one."""
    from repro_torch.train.optimizer import make_adafactor

    mesh = grid((2, 2))
    gen = torch.Generator().manual_seed(1)
    ws = {"a": torch.randn(8, 6, generator=gen),
          "b": torch.randn(8, generator=gen)}
    gs = {k: torch.randn(v.shape, generator=gen) for k, v in ws.items()}
    opt = make_adafactor()
    plain = {k: v.clone() for k, v in ws.items()}
    opt.update(gs, opt.init(plain), plain, 3)
    specs = {"a": P("data", "model"), "b": P("data")}
    params = {k: _placed(mesh, specs[k], v) for k, v in ws.items()}
    state = {"stats": [
        {"vr": _placed(mesh, P("data"), torch.zeros(8)),
         "vc": _placed(mesh, P("model"), torch.zeros(6))},
        {"v": _placed(mesh, P("data"), torch.zeros(8))}]}
    with C.CollectiveCounter() as c:
        opt.update({k: _placed(mesh, specs[k], v) for k, v in gs.items()},
                   state, params, 3)
    ar = lambda b, g: C.collective_wire_bytes("all-reduce", b, g)  # noqa: E731
    want = ar(4 * 4, 2) + ar(3 * 4, 2) + ar(4, 2) + ar(4, 4) + ar(4, 2)
    for idx in mesh.positions():
        assert c.by_position[idx] == {"all-reduce": want}
    for k in ws:
        assert torch.allclose(gather(params[k]), plain[k], rtol=0,
                              atol=1e-7), k
