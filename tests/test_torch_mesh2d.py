"""The port's 2-D (data x model) mesh against the JAX package, on the CPU.

Twins of ``tests/test_mesh2d.py``'s 24 test functions, run on the port
(``device="cpu"``, the kernels' plain versions), then the port's own
cases: sparse verdicts, packed and unfused bytes, an overflow on one
position, the parse-first route's depth check, and the model-slice memo.

The JAX package runs these paths over ``jax.devices()`` (one CPU device
here, so its meshes are 1 x 1).  The port's meshes are
:class:`~repro_torch.launch.mesh.FilterMesh` grids with the CPU device
repeated at every position, (1, 1), (2, 1), (1, 2), (2, 2) and (4, 1),
the counterpart of the JAX file's ``--xla_force_host_platform_device_count``
matrix.  Every verdict is held, bit for bit, against the JAX package's
unsharded result and its (1, 1)-mesh 2-D result on the same seeded
inputs; ``make_filter_mesh``'s shape rules are held against the JAX
function's meshes at 1, 4 and 8 devices, computed in one subprocess with
``--xla_force_host_platform_device_count=8``.  Verdicts are 0/1 and int32
ordinals: exact equality throughout.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_sharded import JAX, PORT, _gen, pair, pool  # noqa: E402
from test_torch_streaming import assert_same, port_batch, port_bytes  # noqa: E402

from repro.core.events import ByteBatch, EventBatch  # noqa: E402
from repro.core.events import encode_bytes as jax_encode  # noqa: E402
from repro.core.events import pack_segments as jax_pack  # noqa: E402
from repro.data.filter_stage import FilterStage as JaxStage  # noqa: E402
from repro.launch.mesh import make_filter_mesh as jax_filter_mesh  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core.dictionary import TagDictionary  # noqa: E402
from repro_torch.core.events import DepthOverflow  # noqa: E402
from repro_torch.core.nfa import compile_queries  # noqa: E402
from repro_torch.data.filter_stage import FilterStage  # noqa: E402
from repro_torch.launch.mesh import (FilterMesh, make_filter_mesh,  # noqa: E402
                                     mesh_shape)

ALL_ENGINES = ("levelwise", "matscan", "oracle", "streaming", "wavefront",
               "yfilter")
DEVICE_ENGINES = ("levelwise", "matscan", "streaming", "wavefront")
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
ROOT = os.path.join(os.path.dirname(__file__), "..")


def cpu_mesh(data: int, model: int) -> FilterMesh:
    """A (data, model) grid with the CPU device at every position."""
    return FilterMesh([["cpu"] * model for _ in range(data)])


def parts_for(model: int) -> int:
    """A part count the model axis divides (two parts at least)."""
    return max(2, model)


def jax_2d(jeng, batch, n_parts, data_shards):
    """The JAX package's 2-D result on its (1, 1) mesh here."""
    mesh = jax_filter_mesh(n_parts, data_shards=data_shards)
    return jeng.filter_batch_sharded2d(batch, jeng.plan_sharded(n_parts),
                                       mesh=mesh)


def same_sparse(a, b):
    for k in ("doc_ids", "query_ids", "first_event"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert_same(a.densify(), b.densify())


# --------------------------------------- the JAX meshes at 1, 4, 8 devices
_JAX_SHAPES = r'''
import json
import jax
import repro.launch.mesh as mm

devices = jax.devices()
assert len(devices) == 8, devices


class FirstN:
    """jax with only the first n of the 8 host devices visible."""

    def __init__(self, n):
        self.n = n

    def devices(self):
        return devices[:self.n]

    def make_mesh(self, *args, **kw):
        return jax.make_mesh(*args, **kw)


out = {}
for n in (1, 4, 8):
    mm.jax = FirstN(n)
    for parts in (None, 1, 2, 3, 4, 5, 6, 8):
        for data in (1, 2, 3, 4, 7, 8, 11):
            mesh = mm.make_filter_mesh(parts, data_shards=data)
            out[f"{n}:{parts}:{data}"] = [tuple(mesh.axis_names),
                                          dict(mesh.shape)]
print(json.dumps(out))
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: on a loaded machine
    (the suite's other workers) a parallel region waits on its slowest
    thread, which can stretch each small op a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_shapes():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_SHAPES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture
def cards(monkeypatch):
    """Pretend ``n`` cards are visible: ``make_filter_mesh`` only counts
    them and names their devices (no stream is made until a launch)."""

    def visible(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    return visible


# ------------------------------------------------------------------ the mesh
class TestFilterMesh2D:
    def test_axes_are_data_model(self):
        mesh = make_filter_mesh(2, data_shards=2, device="cpu")
        assert tuple(mesh.axis_names) == ("data", "model") \
            == tuple(jax_filter_mesh(2, data_shards=2).axis_names)
        assert cpu_mesh(2, 2).shape == {"data": 2, "model": 2}

    def test_data_shards_shrink_to_divisor(self, jax_shapes, cards):
        """Any request is placeable: the data axis shrinks to the largest
        divisor of the device count, as the JAX function shrinks it at 1,
        4 and 8 devices."""
        for n in (1, 4, 8):
            cards(n)
            for req in (1, 2, 3, 4, 7, 8, n + 3):
                shape = make_filter_mesh(data_shards=req).shape
                assert n % shape["data"] == 0
                assert shape["data"] <= max(req, 1)
                assert shape["data"] * shape["model"] <= n
                assert shape == jax_shapes[f"{n}:None:{req}"][1], (n, req)

    def test_model_axis_divides_parts(self, jax_shapes, cards):
        for n in (1, 4, 8):
            cards(n)
            for parts in (1, 2, 3, 5, 6, 8):
                for data in (1, 2, 3, 4, 7, 8, 11):
                    mesh = make_filter_mesh(parts, data_shards=data)
                    assert parts % mesh.shape["model"] == 0
                    names, want = jax_shapes[f"{n}:{parts}:{data}"]
                    assert (list(mesh.axis_names), mesh.shape) \
                        == (names, want), (n, parts, data)
                    assert mesh_shape(n, parts, data_shards=data) \
                        == (want["data"], want["model"])
                    # the first data x model cards, each once
                    assert mesh.devices == [torch.device("cuda", i) for i in
                                            range(mesh.size)]

    def test_invalid_arguments_raise(self):
        with pytest.raises(ValueError, match="data_shards"):
            make_filter_mesh(data_shards=0, device="cpu")
        with pytest.raises(ValueError, match="n_parts"):
            make_filter_mesh(0, device="cpu")
        with pytest.raises(ValueError, match="data_shards"):
            jax_filter_mesh(data_shards=0)
        with pytest.raises(ValueError, match="n_parts"):
            jax_filter_mesh(0)
        with pytest.raises(ValueError, match="rectangular"):
            FilterMesh([["cpu", "cpu"], ["cpu"]])
        if not torch.cuda.is_available():
            # the card is the default, and there is no CPU fallback
            with pytest.raises(RuntimeError, match="no CUDA card"):
                make_filter_mesh(2, data_shards=2)

    def test_full_device_grid(self, jax_shapes, cards):
        """data × model covers every device when both axes are asked for."""
        for n in (1, 4, 8):
            cards(n)
            mesh = make_filter_mesh(n, data_shards=n)
            assert mesh.shape["data"] * mesh.shape["model"] == n
            assert mesh.shape == jax_shapes[f"{n}:{n}:{n}"][1]
            assert len(set(mesh.devices)) == n
        assert make_filter_mesh(4, data_shards=4, device="cpu").shape \
            == {"data": 1, "model": 1}


# -------------------------------------------------------- plan metadata
class TestPlanPrepMetadata:
    """Every engine's plan records its document-prep form — what the 2-D
    bytes route keys the parse-on-the-position vs parse-first decision
    on — as the JAX engine's does."""

    EXPECTED = {"streaming": "events-device", "matscan": "events-device",
                "levelwise": "levels-host", "wavefront": "levels-host",
                "oracle": "host", "yfilter": "host"}

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_prep_recorded(self, name):
        eng, jeng, *_ = pair(name)
        assert eng.plan_.meta["prep"] == self.EXPECTED[name] \
            == jeng.plan_.meta["prep"]

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_prep_survives_sharded_stacking(self, name):
        eng, *_ = pair(name)
        sp = eng.plan_sharded(2)
        assert sp.plans[0].meta["prep"] == self.EXPECTED[name]
        if eng.device_sharded:
            assert sp.stacked().meta["prep"] == self.EXPECTED[name]
            sub = sp.model_slice(1, 2, torch.device("cpu"))
            assert sub.stacked().meta["prep"] == self.EXPECTED[name]
            assert sub.stacked().meta["n_parts"] == 1


# ------------------------------------------------------- 2-D equivalence
class Test2DEquivalence:
    """Every engine, several (parts × data × model) shapes, bit-identical
    to the unsharded path and to the JAX package's."""

    @pytest.mark.parametrize("name", ALL_ENGINES)
    @pytest.mark.parametrize("n_parts,data,model",
                             [(1, 1, 1), (1, 2, 1), (2, 2, 2), (2, 1, 2),
                              (4, 4, 1)])
    def test_2d_equals_unsharded(self, name, n_parts, data, model):
        eng, jeng, pb, batch, _, _ = pair(name, seed=1)
        want = jeng.filter_batch(batch)
        sp = eng.plan_sharded(n_parts)
        got = eng.filter_batch_sharded2d(pb, sp, mesh=cpu_mesh(data, model))
        assert_same(want, got)
        assert_same(eng.filter_batch(pb), got)
        if name in DEVICE_ENGINES and (data, model) == (2, 2):
            assert_same(jax_2d(jeng, batch, n_parts, data), got)
        assert got.matched.any()

    @pytest.mark.parametrize("name", ("oracle", "yfilter"))
    def test_host_engine_bytes_dispatch_honours_n_events(self, name):
        """The host-engine part loop takes an explicit event bound (the
        pipelined route passes one, from the host copy)."""
        eng, jeng, pb, batch, _, _ = pair(name, seed=6)
        docs = list(batch.streams())
        sp = eng.plan_sharded(2)
        bb = ByteBatch.from_buffers(
            [jax_encode(x, text_fill=8) for x in docs], bucket=1024)
        n_events = bb.event_bound(bucket=128)
        handle = eng.dispatch_bytes_sharded2d(
            port_bytes(bb), sp, mesh=cpu_mesh(2, 2), n_events=n_events)
        got = handle()
        want = jeng.filter_batch(EventBatch.from_streams(docs, bucket=128))
        np.testing.assert_array_equal(got.matched, want.matched)
        jgot = jeng.dispatch_bytes_sharded2d(
            bb, jeng.plan_sharded(2), mesh=jax_filter_mesh(2, data_shards=2),
            n_events=n_events)()
        assert_same(jgot, got)

    @pytest.mark.parametrize("name", ALL_ENGINES)
    def test_bytes_2d_equals_unsharded(self, name):
        """The bytes route (K2 at each position for streaming, the device
        parse then the filter for matscan, parse-first for the levelwise
        engines, the part loop for host engines) equals the unsharded
        event path of the JAX package."""
        eng, jeng, pb, batch, _, _ = pair(name, seed=3)
        docs = list(batch.streams())
        bb = ByteBatch.from_buffers(
            [jax_encode(x, text_fill=8) for x in docs], bucket=1024)
        want = jeng.filter_batch(EventBatch.from_streams(docs, bucket=128))
        for data, model in ((2, 2), (4, 1)):
            got = eng.filter_bytes_sharded2d(port_bytes(bb),
                                             eng.plan_sharded(2),
                                             mesh=cpu_mesh(data, model))
            assert_same(want, got)

    @pytest.mark.parametrize("name", DEVICE_ENGINES)
    def test_ragged_batch_is_padded_and_sliced(self, name):
        """A batch size that does not divide the data axis gains inert pad
        documents on the way in and loses them on the way out."""
        eng, jeng, pb, batch, _, _ = pair(name, seed=2, n_docs=5)
        assert pb.batch_size == 5
        sp = eng.plan_sharded(2)
        for data, model in ((4, 2), (2, 1)):
            got = eng.filter_batch_sharded2d(pb, sp,
                                             mesh=cpu_mesh(data, model))
            want = jeng.filter_batch(batch)
            assert got.matched.shape == want.matched.shape
            assert_same(want, got)

    def test_dispatch_is_deferred_and_correct(self):
        """dispatch_* returns a materializer: calling it yields the blocking
        convenience's verdicts."""
        eng, jeng, pb, batch, _, _ = pair("streaming", seed=4)
        sp = eng.plan_sharded(2)
        mesh = cpu_mesh(2, 2)
        handle = eng.dispatch_batch_sharded2d(pb, sp, mesh=mesh)
        assert callable(handle)
        res = handle()
        assert_same(eng.filter_batch_sharded2d(pb, sp, mesh=mesh), res)
        assert_same(jax_2d(jeng, batch, 2, 2), res)

    def test_2d_after_churn_matches_fresh_compile(self):
        """The 2-D path runs a churned, then rebalanced, plan as a fresh
        compile of the surviving set, and as the JAX package's 2-D path
        after the same churn; every new plan gets new model slices."""
        eng, jeng, pb, batch, _, d = pair("streaming", seed=5)
        jsp = jeng.plan_sharded(2)
        sp0 = sp = eng.plan_sharded(2)
        mesh = cpu_mesh(2, 2)
        before = eng.filter_batch_sharded2d(pb, sp0, mesh=mesh)
        old_slice = sp0.model_slice(1, 2, torch.device("cpu"))
        qs = pool(5, n=10)
        jqs = pool(5, n=10, pkg=JAX)
        sp, gids = sp.add_queries(qs[:3])
        jsp, jgids = jsp.add_queries(jqs[:3])
        assert gids == jgids
        sp = sp.remove_queries([int(sp.live_ids()[0]), gids[1]])
        jsp = jsp.remove_queries([int(jsp.live_ids()[0]), jgids[1]])
        got = eng.filter_batch_sharded2d(pb, sp, mesh=mesh)
        fresh = engines.create("streaming", compile_queries(
            list(sp.live_queries()), d, shared=True), dictionary=d,
            device="cpu")
        assert_same(fresh.filter_batch(pb), got)
        assert_same(jeng.filter_batch_sharded2d(
            batch, jsp, mesh=jax_filter_mesh(2, data_shards=2)), got)
        assert sp.model_slice(1, 2, torch.device("cpu")) is not old_slice
        # a batch of the old epoch keeps its plan and slices
        assert_same(before, eng.filter_batch_sharded2d(pb, sp0, mesh=mesh))
        assert sp0.model_slice(1, 2, torch.device("cpu")) is old_slice
        sp2, stats = sp.rebalance(tolerance=0.0)
        got2 = eng.filter_batch_sharded2d(pb, sp2, mesh=mesh)
        assert_same(fresh.filter_batch(pb), got2)

    def test_mesh_without_axes_raises(self):
        eng, *_ = pair("streaming")
        _, jeng, _, batch, _, _ = pair("streaming")
        sp = eng.plan_sharded(1)
        pb = port_batch(batch)
        bad = FilterMesh(["cpu"], axis_names=("model",))
        with pytest.raises(ValueError, match="data"):
            eng.filter_batch_sharded2d(pb, sp, mesh=bad)
        with pytest.raises(ValueError, match="mesh"):
            eng.filter_batch_sharded2d(pb, sp, mesh=None)
        import jax
        with pytest.raises(ValueError, match="data"):
            jeng.filter_batch_sharded2d(batch, jeng.plan_sharded(1),
                                        mesh=jax.make_mesh((1,), ("model",)))

    def test_model_axis_part_mismatch_raises(self):
        """A model axis that does not divide the parts raises, on the 2-D
        path and on ``mesh=`` of the 1-D filters (the JAX test skips on
        one device; the port's CPU mesh has the 4-wide axis)."""
        eng, _, pb, _, _, _ = pair("streaming")
        sp = eng.plan_sharded(3)
        mesh = cpu_mesh(1, 4)
        with pytest.raises(ValueError, match="not divisible"):
            eng.filter_batch_sharded2d(pb, sp, mesh=mesh)
        with pytest.raises(ValueError, match="not divisible"):
            eng.filter_batch_sharded(pb, sp, mesh=mesh)


# -------------------------------------------------- batch-axis padding
class TestBatchAxisPadding:
    def test_event_batch_pad_batch_to(self):
        _, _, pb, batch, _, _ = pair("streaming")
        b = batch.batch_size
        padded = pb.pad_batch_to(8)
        want = batch.pad_batch_to(8)
        assert padded.batch_size == 8 and padded.length == pb.length
        for k in ("kind", "tag_id", "depth", "parent", "valid", "n_events"):
            np.testing.assert_array_equal(getattr(padded, k),
                                          np.asarray(getattr(want, k)))
        assert not padded.valid[b:].any()
        assert (padded.n_events[b:] == 0).all()
        assert pb.pad_batch_to(b) is pb
        with pytest.raises(ValueError):
            pb.pad_batch_to(1)
        # a batch on a device pads there
        dev = tev.EventBatch(*(torch.from_numpy(np.asarray(getattr(pb, k)))
                               for k in ("kind", "tag_id", "depth", "parent",
                                         "valid", "n_events")))
        dpad = dev.pad_batch_to(8)
        assert dpad.is_device
        for k in ("kind", "tag_id", "depth", "parent", "valid", "n_events"):
            np.testing.assert_array_equal(getattr(dpad, k).numpy(),
                                          getattr(padded, k))

    def test_byte_batch_pad_batch_to(self):
        jbb = ByteBatch.from_buffers([b"<ab>x</ab>", b"<cd>"], bucket=16)
        bb = port_bytes(jbb)
        padded = bb.pad_batch_to(4)
        assert padded.batch_size == 4
        np.testing.assert_array_equal(padded.data,
                                      np.asarray(jbb.pad_batch_to(4).data))
        assert (padded.data[2:] == 0).all() and (padded.n_bytes[2:] == 0).all()
        # zero bytes decode to zero events: the bound is unchanged
        assert padded.event_bound() == bb.event_bound()
        with pytest.raises(ValueError):
            bb.pad_batch_to(1)
        # packed segments pad with inert ones, as the JAX package's do
        _, _, _, batch, _, _ = pair("streaming", seed=3)
        jbb = ByteBatch.from_buffers(
            [jax_encode(x, text_fill=8) for x in batch.streams()],
            bucket=512)
        jsp = jax_pack(jbb, target_len=256)
        sp = tev.pack_segments(port_bytes(jbb), target_len=256)
        s = sp.n_segments + 3
        for k in ("data", "starts", "doc_ids", "n_bytes"):
            np.testing.assert_array_equal(
                getattr(sp.pad_segments_to(s), k),
                np.asarray(getattr(jsp.pad_segments_to(s), k)))
        assert sp.pad_segments_to(sp.n_segments) is sp
        with pytest.raises(ValueError):
            sp.pad_segments_to(1)

    def test_byte_batch_device_put(self):
        """Staging over a mesh: padded to the data axis, every position's
        slice of the rows on its device, bytes preserved."""
        _, _, _, batch, _, _ = pair("streaming", n_docs=3)
        jbb = ByteBatch.from_buffers([jax_encode(x) for x in
                                      batch.streams()], bucket=256)
        bb = port_bytes(jbb)
        mesh = cpu_mesh(2, 2)
        placed = bb.device_put(mesh)
        assert placed.batch_size % 2 == 0 and placed.mesh is mesh
        np.testing.assert_array_equal(placed.host.data[:3], bb.data)
        # the JAX package's placement on its one device, padded to 1
        jplaced = jbb.device_put(jax_filter_mesh(data_shards=2)).to_host()
        np.testing.assert_array_equal(placed.host.data[:3],
                                      np.asarray(jplaced.data)[:3])
        assert (placed.host.data[3:] == 0).all()
        rows = placed.batch_size // 2
        for idx in mesh.positions():
            d = idx[0]
            got = placed.take(idx)
            assert got.device == torch.device("cpu")
            np.testing.assert_array_equal(
                got.numpy(), placed.host.data[d * rows:(d + 1) * rows])


# ------------------------------------------------------ stage integration
class TestStage2D:
    def _routes(self, batches):
        return {(r.doc_index, r.shard): tuple(int(x) for x in
                                              r.matched_profiles)
                for b in batches for r in b}

    def _workload(self, seed=6, n_docs=11):
        """(port profiles, port docs, port raw, JAX profiles, JAX docs)."""
        qs, docs, _ = _gen(PORT, "streaming", seed, n_docs, 18)
        jqs, jdocs, _ = _gen(JAX, "streaming", seed, n_docs, 18)
        raw = [tev.encode_bytes(x, text_fill=8) for x in docs]
        return qs, docs, raw, jqs, jdocs

    def _stage(self, qs, **kw):
        return FilterStage(qs, TagDictionary(), engine="streaming",
                           device="cpu", **kw)

    def test_routing_identical_with_and_without_data_shards(self):
        qs, docs, raw, jqs, jdocs = self._workload()
        from repro.core.dictionary import TagDictionary as JaxDictionary
        jmono = JaxStage(jqs, JaxDictionary(), n_shards=3,
                         engine="streaming", batch_size=4)
        want = self._routes(jmono.route(jdocs))
        mono = self._stage(qs, n_shards=3, batch_size=4)
        for mesh in (None, cpu_mesh(2, 2), cpu_mesh(4, 1)):
            two_d = self._stage(qs, n_shards=3, batch_size=4,
                                query_shards=2, data_shards=2, mesh=mesh)
            assert two_d.mesh.shape.keys() == {"data", "model"}
            assert self._routes(mono.route(docs)) == want \
                == self._routes(two_d.route(docs))
            assert self._routes(mono.route_bytes(raw)) \
                == self._routes(two_d.route_bytes(raw)) == want

    def test_pipelined_routes_like_synchronous(self):
        """The pipelined route is an optimisation, not a semantic: its
        routes equal route_bytes exactly."""
        qs, docs, raw, _, _ = self._workload(seed=7)
        a = self._stage(qs, n_shards=2, batch_size=4, data_shards=2,
                        mesh=cpu_mesh(2, 1))
        b = self._stage(qs, n_shards=2, batch_size=4, data_shards=2)
        # a generator: the route must stream (stage one batch ahead, never
        # materialize the whole payload iterable)
        got = self._routes(a.route_bytes_pipelined(iter(raw)))
        want = self._routes(b.route_bytes(raw))
        assert got == want
        # 3 batches of 4: the last two were staged while a predecessor was
        # in flight
        assert a.stats["overlapped_batches"] == 2
        assert a.stats["put_seconds"] >= 0.0

    def test_pipelined_falls_back_without_mesh(self):
        qs, docs, raw, _, _ = self._workload(seed=8, n_docs=5)
        stage = self._stage(qs, n_shards=2, batch_size=4)
        assert stage.mesh is None
        got = self._routes(stage.route_bytes_pipelined(raw))
        want = self._routes(self._stage(qs, n_shards=2, batch_size=4)
                            .route_bytes(raw))
        assert got == want

    def test_data_shards_only_needs_no_query_shards(self):
        """data_shards=2 with a monolithic query set still runs the 2-D
        path (one part, stacked) and routes identically."""
        qs, docs, raw, _, _ = self._workload(seed=9, n_docs=6)
        mono = self._stage(qs, n_shards=2, batch_size=3)
        ds = self._stage(qs, n_shards=2, batch_size=3, data_shards=2,
                         mesh=cpu_mesh(2, 1))
        assert ds.sharded_ is not None and ds.sharded_.n_parts == 1
        assert self._routes(mono.route(docs)) == self._routes(ds.route(docs))

    def test_churn_on_2d_stage_route_parity(self):
        qs, docs, raw, jqs, jdocs = self._workload(seed=10, n_docs=6)
        from repro.core.dictionary import TagDictionary as JaxDictionary
        extra = pool(10, n=3)
        jextra = pool(10, n=3, pkg=JAX)
        mono = self._stage(qs, n_shards=2, batch_size=3)
        two_d = self._stage(qs, n_shards=2, batch_size=3, query_shards=2,
                            data_shards=2, mesh=cpu_mesh(2, 2))
        jmono = JaxStage(jqs, JaxDictionary(), n_shards=2,
                         engine="streaming", batch_size=3)
        for stage, ex in ((mono, extra), (two_d, extra), (jmono, jextra)):
            gids = [stage.subscribe(q) for q in ex]
            stage.unsubscribe(gids[1])
        assert self._routes(mono.route(docs)) \
            == self._routes(two_d.route(docs)) \
            == self._routes(jmono.route(jdocs))
        two_d.maybe_rebalance(tolerance=0.0)
        assert self._routes(two_d.route_bytes(raw)) \
            == self._routes(mono.route_bytes(raw))

    def test_throughput_reports_per_axis_stats(self):
        qs, docs, raw, _, _ = self._workload(seed=11, n_docs=5)
        stage = self._stage(qs, n_shards=2, batch_size=4, query_shards=2,
                            data_shards=2, mesh=cpu_mesh(2, 2))
        list(stage.route_bytes_pipelined(raw))
        tp = stage.throughput()
        shape = stage.mesh.shape
        assert tp["data_shards"] == 2
        assert tp["mesh_data"] == shape["data"] == 2
        assert tp["mesh_model"] == shape["model"] == 2
        assert tp["docs_per_s_per_data_shard"] == pytest.approx(
            tp["docs_per_s"] / shape["data"])
        assert tp["queries_per_model_shard"] >= len(qs) // 2
        assert "put_s" in tp and "overlapped_batches" in tp
        # the placed mesh of one CPU device is 1 x 1, as the JAX
        # package's is on one device
        placed = self._stage(qs, n_shards=2, batch_size=4, query_shards=2,
                             data_shards=2)
        assert (placed.throughput()["mesh_data"],
                placed.throughput()["mesh_model"]) == (1, 1)


# ------------------------------------------------- what the port adds
@pytest.mark.parametrize("name", ALL_ENGINES)
@pytest.mark.parametrize("data,model", MESHES)
def test_sparse_2d_equals_jax(name, data, model):
    """The sparse 2-D route (K4 at each position for streaming, the
    gathered dense result sparsified otherwise) equals the JAX package's
    (1, 1)-mesh sparse route and its unsharded result, ids, ordinals and
    all, over a tombstoned plan."""
    eng, jeng, pb, batch, _, _ = pair(name, seed=1)
    n_parts = parts_for(model)
    sp = eng.plan_sharded(n_parts).remove_queries([1, 4])
    jsp = jeng.plan_sharded(n_parts).remove_queries([1, 4])
    got = eng.filter_batch_sharded2d_sparse(pb, sp,
                                            mesh=cpu_mesh(data, model))
    want = jeng.filter_batch_sharded2d_sparse(
        batch, jsp, mesh=jax_filter_mesh(n_parts, data_shards=data))
    same_sparse(want, got)
    np.testing.assert_array_equal(got.live_ids, want.live_ids)
    assert got.meta["path"] == ("kernel-fused" if name == "streaming"
                                else "dense-2d")
    assert_same(jeng.filter_batch_sharded(batch, jsp), got.densify())
    assert got.n_matches > 1


def test_sparse_2d_overflow_on_one_position():
    """Each position's buffer bounds ``cap`` on its own: at a cap both fit
    (their sum does not) the route stays in the kernel; at one less, the
    busier position overflows while the other fits, and the whole request
    goes down the dense 2-D route, exact."""
    # seed 2: the two halves of the batch emit 3 and 7 rows
    eng, jeng, pb, batch, _, _ = pair("streaming", seed=2, n_docs=6)
    sp = eng.plan_sharded(2)
    want = jeng.filter_batch(batch)
    rows = [eng.filter_batch_sharded2d_sparse(
        pb.rows(3 * d, 3 * d + 3), sp, mesh=cpu_mesh(1, 1),
        match_cap=10_000).meta["device_rows"] for d in (0, 1)]
    assert rows[0] != rows[1] and min(rows) > 0
    mesh = cpu_mesh(2, 1)
    fit = eng.filter_batch_sharded2d_sparse(pb, sp, mesh=mesh,
                                            match_cap=max(rows))
    assert fit.meta["path"] == "kernel-fused" and not fit.overflowed
    assert fit.meta["device_rows"] == sum(rows) > max(rows)
    assert_same(want, fit.densify())
    over = eng.filter_batch_sharded2d_sparse(pb, sp, mesh=mesh,
                                             match_cap=max(rows) - 1)
    assert min(rows) <= max(rows) - 1
    assert over.overflowed and over.meta["path"] == "dense-overflow"
    assert over.meta["attempted_path"] == "kernel-fused"
    assert_same(want, over.densify())


@pytest.mark.parametrize("opts", [{"pack": True, "segment_target": 256},
                                  {"fuse": False},
                                  {"pack": True, "fuse": False}],
                         ids=["pack", "unfused", "pack-unfused"])
@pytest.mark.parametrize("data,model", [(2, 2), (4, 1), (1, 2)])
def test_bytes_2d_pack_and_unfused(opts, data, model):
    """Packed segments (padded with inert ones after packing) and the
    unfused route (K5, then K1, at each position) equal the JAX package's
    unsharded result and its (1, 1)-mesh bytes route."""
    eng, jeng, pb, batch, _, _ = pair("streaming", seed=3, n_docs=7, **opts)
    docs = list(batch.streams())
    bb = ByteBatch.from_buffers([jax_encode(x, text_fill=8) for x in docs],
                                bucket=1024)
    n_parts = parts_for(model)
    got = eng.filter_bytes_sharded2d(port_bytes(bb), eng.plan_sharded(n_parts),
                                     mesh=cpu_mesh(data, model))
    assert_same(jeng.filter_batch(EventBatch.from_streams(docs, bucket=128)),
                got)
    assert_same(jeng.filter_bytes_sharded2d(
        bb, jeng.plan_sharded(n_parts),
        mesh=jax_filter_mesh(n_parts, data_shards=data)), got)


@pytest.mark.parametrize("name,opts", [
    ("levelwise", {"use_kernel": True}), ("wavefront", {"use_kernel": True}),
    ("levelwise", {"use_matmul": False})], ids=["levelwise-K6",
                                                "wavefront-K6", "gather"])
def test_parse_first_route_with_k6(name, opts):
    """The levelwise engines' 2-D bytes route — the parse on each
    position (K5), host bucketing, then the position's folded states
    (K6's plain version here) — equals the JAX package's unsharded
    route, and names a document nested past ``max_depth`` by its row in
    the whole batch."""
    eng, jeng, pb, batch, _, d = pair(name, seed=3, **opts)
    docs = list(batch.streams())
    raw = [jax_encode(x, text_fill=8) for x in docs]
    bb = ByteBatch.from_buffers(raw, bucket=1024)
    sp = eng.plan_sharded(2)
    got = eng.filter_bytes_sharded2d(port_bytes(bb), sp, mesh=cpu_mesh(2, 2))
    assert_same(jeng.filter_batch(EventBatch.from_streams(docs, bucket=128)),
                got)
    deep = (b"".join(d.open_bytes(0) for _ in range(70))
            + b"".join(d.close_bytes(0) for _ in range(70)))
    bad = tev.ByteBatch.from_buffers(raw[:3] + [deep], bucket=1024)
    with pytest.raises(DepthOverflow) as err:
        eng.filter_bytes_sharded2d(bad, sp, mesh=cpu_mesh(2, 1))
    assert tuple(err.value.doc_indices) == (3,)


def test_model_slices_are_views_memoised_per_plan():
    """A position's model slice of the stacked tables is a view of the
    plan's rows on the plan's device, built once per (plan, device,
    slice); churn builds a new plan and so new slices."""
    eng, *_ = pair("streaming")
    sp = eng.plan_sharded(4)
    cpu = torch.device("cpu")
    a = sp.model_slice(1, 2, cpu)
    assert a is sp.model_slice(1, 2, cpu) and sp.model_slice(0, 1, cpu) is sp
    assert a.n_parts == 2 and list(a.part_cols) == list(sp.part_cols[2:])
    for k, v in a.stacked().tables.items():
        assert v.data_ptr() == sp.stacked()[k][2].data_ptr()
    live = np.concatenate([sp.model_slice(m, 2, cpu).live_ids()
                           for m in range(2)])
    np.testing.assert_array_equal(np.sort(live), sp.live_ids())
    sp2 = sp.remove_queries([int(a.live_ids()[0])])
    assert sp2.model_slice(1, 2, cpu) is not a
    assert len(sp2.model_slice(1, 2, cpu).live_ids()) \
        == len(a.live_ids()) - 1


def test_stage_2d_sparse_routes_as_jax():
    """A sparse 2-D stage: events through K4 at each position, bytes as
    the gathered dense result sparsified (the JAX stage's route), both
    routing as the JAX package's unsharded sparse stage."""
    qs, docs, _ = _gen(PORT, "streaming", 12, 9, 18)
    jqs, jdocs, _ = _gen(JAX, "streaming", 12, 9, 18)
    raw = [tev.encode_bytes(x, text_fill=8) for x in docs]
    from repro.core.dictionary import TagDictionary as JaxDictionary
    jst = JaxStage(jqs, JaxDictionary(), n_shards=2, engine="streaming",
                   batch_size=4, sparse=True)
    want = {(r.doc_index, r.shard): tuple(int(x) for x in r.matched_profiles)
            for b in jst.route(jdocs) for r in b}
    st = FilterStage(qs, TagDictionary(), n_shards=2, engine="streaming",
                     batch_size=4, sparse=True, device="cpu",
                     query_shards=2, data_shards=2, mesh=cpu_mesh(2, 2))
    for routed in (st.route(docs), st.route_bytes(raw)):
        assert {(r.doc_index, r.shard): tuple(int(x) for x in
                                              r.matched_profiles)
                for b in routed for r in b} == want
    assert st.stats["paths"] == {"kernel-fused": 3, "dense-2d": 3}


def test_engine_without_device_prep_raises_on_prep_arrays():
    eng, *_ = pair("levelwise")
    with pytest.raises(NotImplementedError, match="events-device"):
        eng._prep_arrays(None, None, None, None, None, None)



def test_model_slices_under_threads_are_built_once_per_key():
    """Sixteen threads ask one plan for its model slices at once, with a
    short switch interval: each (slice, device) key hands every thread
    the same plan, and the 2-D route of each thread equals one card's."""
    import threading

    eng, _, pb, _, _, _ = pair("streaming", seed=1)
    sp = eng.plan_sharded(4)
    want = eng.filter_batch_sharded(pb, sp)
    mesh = cpu_mesh(2, 2)
    got, errors = [], []
    old = sys.getswitchinterval()

    def worker():
        try:
            got.append(([sp.model_slice(m, 2, torch.device("cpu"))
                         for m in range(2)],
                        eng.filter_batch_sharded2d(pb, sp, mesh=mesh)))
        except Exception as e:   # reported below, with the thread's
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 16
    for slices, res in got:
        assert all(a is b for a, b in zip(slices, got[0][0]))
        assert_same(want, res)
