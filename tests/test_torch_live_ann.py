"""The port's live ANN index (``avenir_tpu_torch.models.live_ann``, the
overflow tails of ``ops/ivf.ann_core``, ``stream.engine.AnnServingLearner``
and ``knn.ann.live``) against the JAX package on the CPU.

The base index is built in JAX and carried into the port through the
registry snapshot (``pack_ivf_index`` → ``payload.npz`` →
``unpack_ivf_index``): the port's k-means equals JAX's bit for bit only on
integer data, and the carry tests the wire format. The same batches then
go to both indexes. Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.lifecycle import registry as JR
from avenir_tpu.models import knn as jknn
from avenir_tpu.models import live_ann as JL
from avenir_tpu.ops import ivf as JI

from avenir_tpu_torch.lifecycle import registry as TR
from avenir_tpu_torch.lifecycle.retrain import RetrainDaemon
from avenir_tpu_torch.lifecycle.swap import install_state
from avenir_tpu_torch.models import knn as tknn
from avenir_tpu_torch.models import live_ann as TL
from avenir_tpu_torch.ops import ivf as TI
from avenir_tpu_torch.stream.engine import AnnServingLearner, ServingEngine
from avenir_tpu_torch.stream.loop import InProcQueues

torch.set_num_threads(2)

N_BINS = 4


def _clustered(rng, n, d=6, n_clusters=24):
    centers = rng.random((n_clusters, d), dtype=np.float32) * 4.0
    ca = rng.integers(0, n_clusters, n)
    return (centers[ca] + rng.normal(0, 0.08, (n, d))).astype(np.float32)


def _cats(rng, n, f=2):
    return rng.integers(0, N_BINS, (n, f)).astype(np.int32)


def _np(pair):
    return tuple(np.asarray(a) for a in pair)


def _carry(tmp_path, y_num, y_cat, *, nlist, tail_budget, init=None):
    """A JAX-built index adopted by a JAX and a port live index, the port
    reading it from the JAX registry's files."""
    n_bins = N_BINS if y_cat is not None else 0
    jidx = JI.build_ivf(jnp.asarray(y_num),
                        None if y_cat is None else jnp.asarray(y_cat),
                        n_cat_bins=n_bins, nlist=nlist, n_iters=0 if init
                        is not None else 6, seed=0, init_centroids=init)
    reg = str(tmp_path / "carry")
    JR.SnapshotRegistry(reg).publish(
        JL.pack_ivf_index(jidx), kind=JL.IVF_SNAPSHOT_KIND,
        extra=JL.ivf_index_extra(jidx))
    kw = dict(n_cat_bins=n_bins, nlist=nlist, n_iters=0, seed=0,
              tail_budget=tail_budget)
    jlive = JL.LiveAnnIndex(y_num, y_cat, **kw)
    tlive = TL.LiveAnnIndex(y_num, y_cat, device="cpu", **kw)
    jsnap = JR.SnapshotRegistry(reg).latest()
    tsnap = TR.SnapshotRegistry(reg).latest()
    assert tsnap.manifest["extra"] == jsnap.manifest["extra"]
    jlive.adopt(jsnap.restore(), jsnap.manifest["extra"])
    tlive.adopt(tsnap.restore(), tsnap.manifest["extra"])
    return jidx, jlive, tlive


def _assert_same_tails(jlive, tlive):
    assert tlive.tail_cap == jlive.tail_cap
    np.testing.assert_array_equal(tlive._t_len, np.asarray(jlive._t_len))
    np.testing.assert_array_equal(tlive._t_gids, np.asarray(jlive._t_gids))
    np.testing.assert_array_equal(tlive._t_flat, np.asarray(jlive._t_flat))
    assert tlive.n_total == jlive.n_total
    assert tlive.describe() == jlive.describe()


def _query_both(jlive, tlive, x_num, x_cat, **kw):
    want = _np(jlive.query(jnp.asarray(x_num),
                           None if x_cat is None else jnp.asarray(x_cat),
                           **kw))
    got = _np(tlive.query(x_num, x_cat, **kw))
    return got, want


@pytest.mark.parametrize("mixed,probe", [(False, "auto"), (False, "full"),
                                         (True, "auto"), (True, "full")])
def test_query_with_tails_equals_jax(tmp_path, mixed, probe):
    """The JAX-built index plus the same appended batches (a tail doubling
    and a row that raises the int8 scale among them): the tails equal
    JAX's, and the live query equals JAX's ``_live_ann_query``, ids and
    scaled distances, at auto and full probing."""
    rng = np.random.default_rng(7 + mixed)
    y = _clustered(rng, 900)
    y_cat = _cats(rng, 900) if mixed else None
    _, jlive, tlive = _carry(tmp_path, y, y_cat, nlist=8, tail_budget=128)
    for i, n in enumerate((40, 60, 150, 3)):
        b = _clustered(rng, n)
        if i == 2:
            b[5] *= 2.5                  # raises max|y|: re-quantization
        bc = _cats(rng, n) if mixed else None
        assert tlive.append(b, bc) == jlive.append(b, bc)
        _assert_same_tails(jlive, tlive)
    x = _clustered(rng, 40)
    x_cat = _cats(rng, 40) if mixed else None
    n_probe = 8 if probe == "full" else 0
    got, want = _query_both(jlive, tlive, x, x_cat, k=5, n_probe=n_probe)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] >= 900).any()         # appended rows are found


def test_no_appends_equals_the_frozen_index():
    """A live index nobody appended to answers as the frozen index, at
    full and sparse probing."""
    rng = np.random.default_rng(42)
    y = _clustered(rng, 1500)
    x = _clustered(rng, 40)
    frozen = TI.build_ivf(y, nlist=16, n_iters=8, seed=3, device="cpu")
    live = TL.LiveAnnIndex(y, nlist=16, n_iters=8, seed=3, device="cpu")
    for n_probe in (16, 4):
        want = _np(TI.ann_topk(frozen, x, k=5, n_probe=n_probe))
        got = _np(live.query(x, k=5, n_probe=n_probe))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("raise_scale", [False, True])
def test_full_probing_equals_a_fresh_build_over_the_union(raise_scale):
    """Appended rows at ``n_probe = nlist`` equal a fresh ``build_ivf``
    over the union table, also when an appended row raises ``max|y|``
    (the base re-quantizes at the joint scale)."""
    rng = np.random.default_rng(43)
    y = _clustered(rng, 1200)
    extra = _clustered(rng, 300)
    if raise_scale:
        extra[0] *= 3.0
    x = _clustered(rng, 32)
    live = TL.LiveAnnIndex(y, nlist=16, n_iters=8, seed=1, tail_budget=64,
                           device="cpu")
    live.append(extra)
    fresh = TI.build_ivf(np.concatenate([y, extra]), nlist=16, n_iters=8,
                         seed=1, device="cpu")
    got = _np(live.query(x, k=5, n_probe=16))
    want = _np(TI.ann_topk(fresh, x, k=5, n_probe=16))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_append_into_an_empty_list_equals_jax(tmp_path):
    """A list no base row reached (a centroid far from every row) takes
    its tail rows as JAX's does, and its row is its own nearest at one
    probe."""
    rng = np.random.default_rng(44)
    y = rng.random((40, 6)).astype(np.float32)
    far = np.full((1, 6), 8.0, np.float32)
    init = np.concatenate([y[:7], far])
    jidx, jlive, tlive = _carry(tmp_path, y, None, nlist=8, tail_budget=16,
                                init=init)
    assert int(np.asarray(jidx.lengths)[7]) == 0
    row = far + rng.normal(0, 0.01, (1, 6)).astype(np.float32)
    assert tlive.append(row) == jlive.append(row)
    _assert_same_tails(jlive, tlive)
    assert int(tlive._t_len[7]) == 1
    got, want = _query_both(jlive, tlive, row, None, k=1, n_probe=1)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0, 0] == 40


def test_a_doubling_uploads_the_tails_once_and_a_fitting_append_none():
    """Appends within ``tail_cap`` write their rows into the tail buffers
    in place; the doubling append allocates and uploads them once."""
    rng = np.random.default_rng(45)
    live = TL.LiveAnnIndex(_clustered(rng, 800), nlist=8, n_iters=6,
                           seed=0, tail_budget=256, device="cpu")
    uploads0, cap0 = live.tail_uploads, live.tail_cap
    buffers = live._live[1:5]
    while True:
        live.append(_clustered(rng, 4))
        if live.tail_cap != cap0:
            break
        assert live.tail_uploads == uploads0
        assert all(a is b for a, b in zip(live._live[1:5], buffers))
    assert live.tail_cap == 2 * cap0
    assert live.tail_uploads == uploads0 + 1
    buffers = live._live[1:5]
    live.append(_clustered(rng, 4))
    assert live.tail_uploads == uploads0 + 1
    assert all(a is b for a, b in zip(live._live[1:5], buffers))
    # the in-place rows are the host tails'
    L, cap = live._t_len.shape[0], live.tail_cap
    np.testing.assert_array_equal(live._live[1].numpy(),
                                  live._t_flat.reshape(L * cap, -1))
    np.testing.assert_array_equal(live._live[3].numpy(),
                                  live._t_gids.reshape(L * cap))


def test_an_oversize_batch_rebuilds_inline():
    rng = np.random.default_rng(46)
    live = TL.LiveAnnIndex(_clustered(rng, 600), nlist=8, n_iters=6,
                           seed=0, tail_budget=8, device="cpu")
    stats = live.append(_clustered(rng, 500))
    assert stats["inline_rebuild"]
    assert live.inline_rebuilds == 1 and live.version == 1
    assert live.rebuild_requests == 1
    assert live.n_total == 1100 and int(live._t_len.sum()) == 0
    _, ids = _np(live.query(_clustered(rng, 16), k=5))
    assert np.all((ids >= 0) & (ids < 1100))


def test_refusals_equal_jax():
    rng = np.random.default_rng(47)
    y = _clustered(rng, 100)
    for lib in (JL, TL):
        kw = {} if lib is JL else {"device": "cpu"}
        with pytest.raises(ValueError, match="tail_budget") as jx:
            lib.LiveAnnIndex(y, nlist=8, tail_budget=2, **kw)
        live = lib.LiveAnnIndex(y, nlist=8, n_iters=4, seed=0, **kw)
        with pytest.raises(ValueError, match="feature split") as fx:
            live.append(None, np.zeros((4, 2), np.int32))
        if lib is JL:
            want = (str(jx.value), str(fx.value))
    assert (str(jx.value), str(fx.value)) == want


def test_wire_format_both_ways(tmp_path):
    """A JAX snapshot adopts in the port (``_carry``) and a port wave's
    snapshot adopts in JAX: the leaves in the registry's sorted-key order
    with JAX's dtypes, the manifest's extra and schema hash JAX's, and
    both indexes answer alike over it."""
    rng = np.random.default_rng(48)
    y = _clustered(rng, 700)
    jidx, jlive, tlive = _carry(tmp_path, y, None, nlist=8, tail_budget=64)
    tidx = tlive.index
    packed, want = TL.pack_ivf_index(tidx), JL.pack_ivf_index(jidx)
    assert list(packed) == list(want)
    for name in want:
        assert packed[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(packed[name], want[name])
    assert TL.ivf_index_extra(tidx) == JL.ivf_index_extra(jidx)
    assert TR.state_schema_hash(packed) == JR.state_schema_hash(want)

    tlive.append(_clustered(rng, 50))
    reg = str(tmp_path / "wave")
    wave = TL.LiveAnnIndex(np.concatenate([y, _clustered(rng, 50)]),
                           nlist=8, n_iters=3, seed=0, device="cpu")
    result = wave.make_train_fn()()
    assert result["kind"] == JL.IVF_SNAPSHOT_KIND
    TR.SnapshotRegistry(reg).publish(
        result["pytree"], kind=result["kind"],
        train_rows=result["train_rows"], extra=result["extra"])
    jsnap = JR.SnapshotRegistry(reg).latest()
    j2 = JL.LiveAnnIndex(y, nlist=8, n_iters=0, seed=0)
    j2.adopt(jsnap.restore(), jsnap.manifest["extra"])
    x = _clustered(rng, 24)
    for n_probe in (0, j2.index.nlist):
        got = _np(wave.query(x, k=5, n_probe=n_probe))
        want = _np(j2.query(jnp.asarray(x), k=5, n_probe=n_probe))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_a_wave_swap_replays_the_rows_appended_after_it(tmp_path):
    """The drift trigger requests a wave; rows appended after its snapshot
    replay into the new tails, none lost or doubled; the swap's span and
    gauges are recorded; the daemon's thread runs a second wave."""
    from avenir_tpu_torch.obs import telemetry
    registry = TR.SnapshotRegistry(str(tmp_path / "reg"))
    rng = np.random.default_rng(49)
    live = TL.LiveAnnIndex(_clustered(rng, 900), nlist=8, n_iters=6,
                           seed=0, tail_budget=256, rebuild_tail_fill=0.05,
                           registry=registry, device="cpu")
    daemon = RetrainDaemon(registry, live.make_train_fn())
    live.bind_daemon(daemon)
    live.append(_clustered(rng, 200))
    assert live.rebuild_requests >= 1
    assert daemon.run_once() is not None
    live.append(_clustered(rng, 150))
    tracer = telemetry.tracer()
    was = tracer.enabled
    tracer.enabled = True
    try:
        assert live.maybe_swap() == 1
        assert tracer.snapshot()["lifecycle.swap"]["count"] >= 1
    finally:
        tracer.enabled = was
    assert live.swaps == 1 and live.version == 1
    assert live.index.n_real == 1100
    assert int(live._t_len.sum()) == 150 and live.n_total == 1250
    _, ids = _np(live.query(_clustered(rng, 16), k=5))
    assert np.all((ids >= 0) & (ids < 1250))
    # a wave on the daemon's own thread, requested through the monitor
    daemon.start()
    try:
        live.monitor.detectors["ann.tail_fill"]._armed = True
        live.append(_clustered(rng, 40))
        assert daemon.wait_for_waves(2, timeout=60.0)
    finally:
        daemon.stop()
    assert daemon.errors == 0
    assert live.maybe_swap() == daemon.last_version >= 2
    assert live.n_total == 1290 and live.index.n_real >= 1250


def test_a_foreign_snapshot_kind_is_ignored(tmp_path):
    registry = TR.SnapshotRegistry(str(tmp_path / "reg"))
    rng = np.random.default_rng(50)
    live = TL.LiveAnnIndex(_clustered(rng, 300), nlist=8, n_iters=4,
                           seed=0, registry=registry, device="cpu")
    registry.publish({"w": np.zeros(3)}, kind="learner-state")
    assert live.maybe_swap() is None and live.swaps == 0


def test_the_engine_swaps_through_adopt_and_serves(tmp_path):
    """``install_state`` on an ``AnnServingLearner`` routes to
    ``LiveAnnIndex.adopt`` (the rows appended since replay), and a
    ``ServingEngine`` over the learner answers each event with a row id,
    swapping a published index in at a batch boundary."""
    rng = np.random.default_rng(51)
    y = _clustered(rng, 700)
    live = TL.LiveAnnIndex(y, nlist=8, n_iters=6, seed=0, tail_budget=64,
                           device="cpu")
    learner = AnnServingLearner(live, _clustered(rng, 64), k=3)
    assert len(learner.resolve_action_batch(
        learner.next_action_batch_async(4))) == 4
    fresh = TI.build_ivf(y, nlist=8, n_iters=6, seed=5, device="cpu")
    live.append(_clustered(rng, 100))
    install_state(learner, (TL.pack_ivf_index(fresh),
                            TL.ivf_index_extra(fresh)))
    assert live.swaps == 1 and live.index.n_real == 700
    assert int(live._t_len.sum()) == 100 and live.n_total == 800
    learner.warm(8)

    queues = InProcQueues()
    for i in range(40):
        queues.push_event(f"e{i}")
    pending = [(7, (TL.pack_ivf_index(fresh), TL.ivf_index_extra(fresh)))]
    engine = ServingEngine("", learner.actions, {}, queues,
                           learner=learner, min_batch=8, max_batch=8,
                           swap_source=lambda: (pending.pop()
                                                if pending else None),
                           device="cpu")
    stats = engine.run()
    assert stats.events == 40 and stats.swaps == 1
    assert stats.model_version == 7 and live.swaps == 2
    ids = [int(a) for _, acts in queues.actions for a in acts]
    assert len(ids) == 40 and all(0 <= i < live.n_total for i in ids)


# -- the verb ------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    ({"ann": False, "ann_live": True}, "knn.ann=true"),
    ({"ann": True, "ann_live": True, "ann_live_tail_budget": 4},
     r"tail\.budget")])
def test_validation_messages_equal_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as jx:
        jknn.validate_config(jknn.KnnConfig(**kwargs))
    with pytest.raises(ValueError) as tx:
        tknn.validate_config(tknn.KnnConfig(**kwargs))
    assert str(tx.value) == str(jx.value)


def _knn_props(tmp_path, **extra):
    from _torch_parity import write_fixture
    write_fixture(tmp_path, "elearn", 1600, 400, seed=57)
    lines = {"field.delim.regex": ",",
             "feature.schema.file.path": tmp_path / "schema.json",
             "train.data.path": tmp_path / "train.csv",
             "top.match.count": "5", "distance.scale": "1000",
             "validation.mode": "true", "positive.class.value": "fail",
             "output.class.distr": "true", "knn.ann": "true", **extra}
    path = tmp_path / "knn.properties"
    path.write_text("".join(f"{k}={v}\n" for k, v in lines.items()))
    return str(path)


def test_the_live_verb_at_full_probing_is_the_jax_clis(tmp_path, capsys):
    """``knn.ann.live=true`` probing every list: the file and the
    Validation JSON byte-identical to the JAX CLI's (full probing makes
    the result independent of the clustering)."""
    from avenir_tpu.cli.main import main as jmain
    from avenir_tpu_torch.cli.main import main as tmain
    props = _knn_props(tmp_path, **{"knn.ann.live": "true",
                                    "knn.ann.nlist": "8",
                                    "knn.ann.nprobe": "8"})
    test = str(tmp_path / "test.csv")
    jmain(["NearestNeighbor", test, str(tmp_path / "j.txt"), "--conf",
           props, "-D", "plan.enable=false"])
    j_out = capsys.readouterr().out
    tmain(["NearestNeighbor", test, str(tmp_path / "t.txt"), "--conf",
           props, "--device", "cpu"])
    assert capsys.readouterr().out == j_out
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_the_live_verb_at_auto_probing_is_the_frozen_verbs(tmp_path,
                                                           capsys):
    from avenir_tpu_torch.cli.main import main as tmain
    props = _knn_props(tmp_path)
    base = ["NearestNeighbor", str(tmp_path / "test.csv")]
    tmain(base + [str(tmp_path / "frozen.txt"), "--conf", props,
                  "--device", "cpu"])
    want = capsys.readouterr().out
    tmain(base + [str(tmp_path / "live.txt"), "--conf", props, "-D",
                  "knn.ann.live=true", "-D", "knn.ann.live.tail.budget=64",
                  "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert (tmp_path / "live.txt").read_bytes() == \
        (tmp_path / "frozen.txt").read_bytes()
    assert TL.peek_live_index().tail_budget == 64


def test_explain_provenance_equals_jax(tmp_path, capsys):
    """``--explain`` of a live-ANN job, cold and with the live slot warm
    (after a run in the process), prints the JAX CLI's plan."""
    from avenir_tpu import plan as jplan
    from avenir_tpu.cli.main import main as jmain
    from avenir_tpu_torch import plan as tplan
    from avenir_tpu_torch.cli.main import main as tmain
    props = _knn_props(tmp_path, **{"knn.ann.live": "true",
                                    "knn.ann.nlist": "8",
                                    "knn.ann.nprobe": "4"})
    JL._LIVE_SLOT.clear()
    TL._LIVE_SLOT.clear()
    args = ["NearestNeighbor", str(tmp_path / "test.csv")]
    outs = []
    for fn, extra, plan in ((jmain, [], jplan),
                            (tmain, ["--device", "cpu"], tplan)):
        plan.reset_cache()
        fn(args + [str(tmp_path / "o.txt"), "--conf", props, "--explain"]
           + extra)
        cold = capsys.readouterr().out
        fn(args + [str(tmp_path / "o.txt"), "--conf", props, "-D",
                   "plan.enable=false"] + extra)
        capsys.readouterr()
        plan.reset_cache()
        fn(args + [str(tmp_path / "o.txt"), "--conf", props, "--explain"]
           + extra)
        outs.append((cold, capsys.readouterr().out))
    assert outs[1] == outs[0]
    assert "ann=live nlist=8 nprobe=4 index=" in outs[1][0]
    assert "index=cached v=0" in outs[1][1]
    assert "live slot is warm" in outs[1][1]
