"""The options of the prod step over the multi-process worker ring
(``WorkerMesh`` with a ``gloo`` group on the CPU), held to the one-process
run with the same options.

One world-2 spawn runs every scenario of ``tests/_torch_ring_worker.py``
named below while this process computes the one-process runs on one torch
thread (the ranks run on one thread each: the same bits); one world-4
spawn runs what needs a donor two or more ranks away.

* (a) The stream engine (``streams=2``, ``streams=3``; param and int8
  wires, fused and plain routes; MLP and the reduced dense LM) over world
  2: the read plane, ``w``, ``versions`` and every history bit for bit
  (the drift within rtol 1e-6).
* (b) ``faults=`` (a crash re-admitted from a donor on another rank, a
  NaN, a corrupt and a dropped wire group) on both wires, the monolithic
  step and both engines, world 2 and 4: bit for bit, and the controller's
  summary (its wire counters summed over the ranks) equal.
* (c) The chaos controller on ``tests/test_torch_chaos.py``'s numpy
  state, its rows spread over world 2 and 4: the kill's and the
  cross-rank recovery's states, gathered, equal ``repro.chaos``'s bit for
  bit.
* (d) ``publisher=`` with a ``LiveServer`` on each rank serving its first
  worker: the served params equal the one-process server's of that worker
  bit for bit, the swap decisions are equal, a snapshot names its rows; a
  server of another rank's worker raises ``ValueError``.
* (e) ``tuning=``: the schedule resolved on every rank is the one-process
  one and the run is bit for bit; a record that loads on one rank only
  raises ``RuntimeError`` on every rank; the record key names the world.
* (f) Checkpoints of a ranked state: one archive in the one-process
  layout (a ranked archive restores into the one-process state bit for
  bit, and the reverse; the JAX package's ``restore_checkpoint`` reads it
  with identical arrays); save at step k, ``resume(k)`` and one step give
  the uninterrupted run's step k+1 bits.
* (g) ``make_prefill_step`` / ``make_decode_step`` with the batch split
  over the ranks (B=4) and whole on every rank (B=3): logits within rtol
  1e-5 of the one-process step, the greedy tokens of 8 decode steps
  equal. ``make_step(streams=, faults=, tuning=)`` bit for bit.
* (h) The mesh's row copy, gather and agreement; which state entries a
  rank holds rows of; no guard of the ring is left.
"""
import os

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
if not dist.is_available() or not dist.is_gloo_available():
    pytest.skip("torch.distributed with gloo is needed", allow_module_level=True)

import numpy as np  # noqa: E402

import _torch_ring_worker as W  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402

DRIFT_RTOL = 1e-6
SERVE_RTOL = 1e-5
EXACT = tuple(k for k in W.OPTION_HISTORY if k != "disagreement")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (spec, damp) of the controller's JAX hold: a same-rank donor (world 2), a
# donor on another rank by default (0 dead, so 1 re-syncs 3) and by name
CHAOS_SPECS = [("crash:peer=1,step=2,recover=6", 0.0),
               ("crash:peer=0,step=1;crash:peer=3,step=2,recover=6", 0.5),
               ("crash:peer=2,step=1;recover:peer=2,step=5,donor=0", 0.5)]
CHAOS_STATE_STEPS = 8
MAKE_STEP = ("streams2_faults", "faults_int8", "tuning")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(path):
    from repro_torch.launch import tuner as T

    rec = T.build_record([(T.Candidate(R=2, D=1, max_inflight_steps=2),
                           {"fwd": 1.0, "update": 1.0, "gossip": 1.0},
                           None)],
                         key=T.make_key("plane[mlp]", T.mesh_descriptor(
                             "cpu", W.M, world=2), "param"))
    return rec.save(str(path))


def _chaos_state_file(tmp):
    from test_torch_chaos import _np_state

    path = str(tmp / "chaos_state.pt")
    torch.save(_np_state(), path)
    return path


def _chaos_jobs(state_path, specs):
    return [("chaos_state", spec, damp, state_path, CHAOS_STATE_STEPS)
            for spec, damp in specs]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, one_thread):
    tmp = tmp_path_factory.mktemp("options2")
    rec = _record(tmp / "record.json")
    one_dir = str(tmp / "one")
    one_ckpt = W.run_checkpoint(one_dir, None, None)
    state_path = _chaos_state_file(tmp)
    jobs = ([("option", n) for n in W.OPTION_CASES]
            + [("live", False), ("live", True), ("tuning", rec),
               ("tuning_split", rec),
               ("checkpoint", str(tmp / "ranked"), one_dir),
               ("serve", 4), ("serve", 3), ("primitives",), ("entries",)]
            + [("make_step", n, rec) for n in MAKE_STEP]
            + _chaos_jobs(state_path, CHAOS_SPECS))

    def one_process():
        return {"option": {n: W.run_option(n, None) for n in W.OPTION_CASES},
                "live": {o: W.run_live(o, None) for o in (False, True)},
                "tuning": W.run_tuning(rec, None),
                "serve": {B: W.run_serve(B, None) for B in (4, 3)},
                "make_step": {n: W.run_make_step_option(n, rec, None)
                              for n in MAKE_STEP}}

    ranks, one = W.spawn(2, str(tmp / "ranks"), jobs, one_process)
    one["checkpoint"] = one_ckpt
    return {"ranks": ranks, "one": one, "tmp": tmp, "record": rec,
            "state_path": state_path, "jobs": jobs}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, world2):
    tmp = tmp_path_factory.mktemp("options4")
    jobs = ([("option", "chaos_param"), ("option", "chaos_int8_streams3")]
            + _chaos_jobs(world2["state_path"], CHAOS_SPECS[1:]))
    ranks, _ = W.spawn(4, str(tmp), jobs)
    return {"ranks": ranks, "one": world2["one"]}


def _world(request, world):
    return request.getfixturevalue(f"world{world}")


def _cat(parts):
    """Each group's rows of the ranks, concatenated in rank order."""
    return {g: torch.cat([p[g] for p in parts]) for g in parts[0]}


def _hold_run(ranks, job, want, what):
    got = _cat([r[job]["read"] for r in ranks])
    assert got.keys() == want["read"].keys()
    for g, v in want["read"].items():
        assert torch.equal(got[g], v), (what, g)
    for rank, res in enumerate(ranks):
        mine = res[job]
        assert torch.equal(mine["w"], want["w"]), (what, rank)
        if "versions" in want:
            assert torch.equal(mine["versions"], want["versions"]), what


# ---------------------------------------------------------------------------
# (a) the stream engine, (b) faults
# ---------------------------------------------------------------------------

STREAM_CASES = [n for n in W.OPTION_CASES if not n.startswith("chaos")]
CHAOS_CASES = [n for n in W.OPTION_CASES if n.startswith("chaos")]


def _hold_option(ranks, name, want):
    job = ("option", name)
    _hold_run(ranks, job, want, name)
    for res in ranks:
        hist = res[job]["history"]
        for k in EXACT:
            if k in want["history"]:
                np.testing.assert_array_equal(hist[k], want["history"][k],
                                              err_msg=f"{name} {k}")
        np.testing.assert_allclose(hist["disagreement"],
                                   want["history"]["disagreement"],
                                   rtol=DRIFT_RTOL)


@pytest.mark.parametrize("name", STREAM_CASES)
def test_stream_engine_over_ring_matches_one_process(world2, name):
    _hold_option(world2["ranks"], name, world2["one"]["option"][name])
    assert world2["ranks"][0][("option", name)]["summary"]["streams"] >= 2


CHAOS_COUNTERS = ("faults_injected", "rounds_degraded", "peers_dead",
                  "resyncs", "nan_injections", "rounds_sealed",
                  "checksum_rejects", "drops_detected", "resends",
                  "nonfinite_skips", "time_to_detect_steps",
                  "time_to_resync_steps")


@pytest.mark.parametrize("world,name", [(2, n) for n in CHAOS_CASES] + [
    (4, "chaos_param"), (4, "chaos_int8_streams3")])
def test_faults_over_ring_match_one_process(request, world, name):
    run = _world(request, world)
    want = run["one"]["option"][name]
    _hold_option(run["ranks"], name, want)
    assert want["summary"]["resyncs"] == 1.0
    assert want["summary"]["checksum_rejects"] == 1.0
    for res in run["ranks"]:
        got = res[("option", name)]["summary"]
        for k in CHAOS_COUNTERS:
            assert got[k] == want["summary"][k], (name, k)


# ---------------------------------------------------------------------------
# (c) the controller against the JAX package
# ---------------------------------------------------------------------------


def _gather_state(ranks_states):
    """A state from the ranks' states: the row entries' leaves
    concatenated in rank order, the rest rank 0's (equal on every rank)."""
    from repro_torch.launch.mesh import ROW_ENTRIES

    def walk(path, parts):
        first = parts[0]
        if isinstance(first, dict):
            return {k: walk(path + (k,), [p[k] for p in parts])
                    for k in first}
        spread = any(path[:len(e)] == e for e in ROW_ENTRIES)
        if spread and np.ndim(first):
            return np.concatenate([np.asarray(p) for p in parts])
        for p in parts[1:]:
            assert np.asarray(p).tobytes() == np.asarray(first).tobytes(), \
                path
        return np.asarray(first)

    return walk((), ranks_states)


@pytest.mark.parametrize("world,spec,damp",
                         [(2, s, d) for s, d in CHAOS_SPECS]
                         + [(4, s, d) for s, d in CHAOS_SPECS[1:]])
def test_controller_over_ring_matches_jax(request, world, spec, damp):
    """The ranked controller's kill and recovery (a donor on another rank
    in the last two specs), gathered, against ``repro.chaos`` on one
    state, after every step: every leaf bit for bit, the same summary."""
    import jax.numpy as jnp
    from repro import chaos as jchaos
    from test_torch_chaos import _assert_bits, _host, _np_state, _to

    run = _world(request, world)
    job = ("chaos_state", spec, damp, request.getfixturevalue(
        "world2")["state_path"], CHAOS_STATE_STEPS)
    base = _np_state()
    jstate = _to(base, jnp.asarray)
    jc = jchaos.ChaosController(spec, 4, update_delay=1, compensate=damp)
    for t in range(CHAOS_STATE_STEPS):
        jstate, _ = jc.before_step(jstate, None, t)
        got = _gather_state([_host(r[job]["trace"][t]) for r in run["ranks"]])
        _assert_bits(got, _host(jstate), f"step {t}")
    for r in run["ranks"]:
        assert r[job]["summary"] == jc.summary()
    assert jc.resyncs == (1 if "recover" in spec else 0)


# ---------------------------------------------------------------------------
# (d) the publisher and live servers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True])
def test_live_server_over_ring_serves_its_rank_row(world2, overlap):
    want = world2["one"]["live"][overlap]
    for rank, res in enumerate(world2["ranks"]):
        got = res[("live", overlap)]
        j = rank * (W.M // 2)
        assert got["rows"] == [[j, j + 1]] * len(got["rows"])
        assert got[j]["decisions"] == want[j]["decisions"]
        assert got[j]["swaps"] == want[j]["swaps"] and got[j]["swaps"]
        for a, b in zip(tree_leaves(got[j]["served"]),
                        tree_leaves(want[j]["served"])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(not ok for ok, _ in want[0]["decisions"])  # a gate refused


def test_live_server_refuses_another_ranks_worker(world2):
    for res in world2["ranks"]:
        kind, msg = res[("primitives",)]["live_other"]
        assert kind == "ValueError" and "held by rank" in msg


# ---------------------------------------------------------------------------
# (e) tuning
# ---------------------------------------------------------------------------


def test_tuning_over_ring_resolves_one_schedule(world2):
    want = world2["one"]["tuning"]
    assert want["schedule"] == (2, 1, 2, True)
    _hold_run(world2["ranks"], ("tuning", world2["record"]), want, "tuning")
    for res in world2["ranks"]:
        got = res[("tuning", world2["record"])]
        assert got["schedule"] == want["schedule"]
        for k in EXACT:
            if k in want["history"]:
                np.testing.assert_array_equal(got["history"][k],
                                              want["history"][k])


def test_tuning_record_on_one_rank_raises_on_every_rank(world2):
    for res in world2["ranks"]:
        kind, msg = res[("tuning_split", world2["record"])]
        assert kind == "RuntimeError" and "different tuning schedules" in msg


def test_record_key_names_the_world():
    from repro_torch.launch import tuner as T

    assert T.mesh_descriptor("cpu", 4) == "cpu:M4"
    assert T.mesh_descriptor("cpu", 4, world=1) == "cpu:M4"
    assert T.mesh_descriptor("cpu", 4, world=2) == "cpu:M4:world2"


# ---------------------------------------------------------------------------
# (f) checkpoints
# ---------------------------------------------------------------------------


def _ckpt(world2):
    job = [j for j in world2["jobs"] if j[0] == "checkpoint"][0]
    return [r[job] for r in world2["ranks"]], world2["one"]["checkpoint"]


def _equal_states(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert x.tobytes() == y.tobytes(), what


def test_ranked_archive_is_the_one_process_archive(world2):
    """The ranked archive restores into a fresh one-process state as the
    one-process run's state at the step, bit for bit; the ranked run's
    saved rows are the one-process state's; the two archives hold the
    same entries."""
    from repro_torch.checkpoint import restore_checkpoint

    ranks, one = _ckpt(world2)
    assert all(r["path"] == ranks[0]["path"] for r in ranks)
    _equal_states(_gather_state([r["saved"] for r in ranks]), one["saved"],
                  "ranked rows")
    like = tree_map(lambda t: torch.zeros_like(t) if isinstance(
        t, torch.Tensor) else np.zeros_like(t), one["saved"])
    back = restore_checkpoint(os.path.dirname(ranks[0]["path"]), W.CKPT_AT,
                              like)
    _equal_states(back, one["saved"], "restored")
    with np.load(ranks[0]["path"]) as a, np.load(one["path"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_one_process_archive_restores_into_the_ranks(world2):
    ranks, one = _ckpt(world2)
    _equal_states(_gather_state([r["from_one"] for r in ranks]),
                  one["saved"], "from the one-process archive")


def test_ranked_archive_restores_in_jax(world2):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as jax_restore

    ranks, one = _ckpt(world2)
    host = jax.tree.map(np.asarray, {k: v for k, v in one["saved"].items()})
    like = jax.tree.map(jnp.zeros_like, host)
    got = jax_restore(os.path.dirname(ranks[0]["path"]), W.CKPT_AT, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(host)):
        assert np.asarray(a).dtype == b.dtype
        assert np.asarray(a).tobytes() == b.tobytes()


def test_resume_over_ring_gives_the_uninterrupted_step(world2):
    ranks, one = _ckpt(world2)
    for r in ranks:
        _equal_states(r["restored"], r["saved"], "restored")
        _equal_states(r["resumed"][0], r["after"][0], "resumed")
        assert r["resumed"][1] == r["after"][1]
    _equal_states(_gather_state([r["after"][0] for r in ranks]),
                  one["after"][0], "the ranked step after the save")


# ---------------------------------------------------------------------------
# (g) prefill, decode and make_step's options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [4, 3])
def test_prefill_decode_over_ring(world2, B):
    """B=4 splits over the two ranks (a rank's cache holds 2 rows), B=3
    runs whole on each; the logits within rtol 1e-5, the greedy tokens of
    8 decode steps equal."""
    want = world2["one"]["serve"][B]
    for res in world2["ranks"]:
        got = res[("serve", B)]
        assert got["cache_rows"][1] == (B // 2 if B % 2 == 0 else B)
        torch.testing.assert_close(got["prefill"], want["prefill"],
                                   rtol=SERVE_RTOL, atol=1e-6)
        for a, b in zip(got["decode"], want["decode"]):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=SERVE_RTOL, atol=1e-6)
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", MAKE_STEP)
def test_make_step_options_over_ring(world2, name):
    want = world2["one"]["make_step"][name]
    job = ("make_step", name, world2["record"])
    _hold_run(world2["ranks"], job, want, name)
    for res in world2["ranks"]:
        assert res[job]["losses"] == want["losses"]
        assert res[job]["chaos"] == want["chaos"]
    if name != "tuning":
        assert want["chaos"]["resyncs"] == 1


# ---------------------------------------------------------------------------
# (h) the mesh's primitives, the state's entries, no guard left
# ---------------------------------------------------------------------------


def test_row_copy_over_ring(world2):
    full = W.hop_full(W.M, "float32")
    for rank, res in enumerate(world2["ranks"]):
        for (src, dst), got in res[("primitives",)]["copies"].items():
            want = full.clone()
            want[dst] = full[src]
            assert torch.equal(got, want[2 * rank:2 * rank + 2]), (src, dst)


def test_gather_rows_and_agreement(world2):
    full = W.hop_full(W.M, "float32")
    for rank, res in enumerate(world2["ranks"]):
        p = res[("primitives",)]
        for dst, got in zip((0, 1), p["gather"]):
            if rank == dst:
                assert torch.equal(got, full)
            else:
                assert got is None
        assert p["agree_same"] == {"R": 2, "D": [1, None]}
        kind, msg = p["agree_differ"]
        assert kind == "RuntimeError" and "different ranks" in msg


def test_ranked_state_entries(world2):
    """A rank holds its 2 rows of the row entries and all 4 of ``w``,
    ``versions`` and ``alive``-free host leaves: what the checkpoint and
    the re-sync take from ``launch.mesh.ROW_ENTRIES``."""
    from repro_torch.launch.mesh import ROW_ENTRIES, WORKER_ENTRIES

    for res in world2["ranks"]:
        for key, lead in res[("entries",)].items():
            top = key.split("'")[1]
            sub = key.split("'")[3] if key.count("'") > 2 else None
            spread = (top,) in ROW_ENTRIES or (top, sub) in ROW_ENTRIES
            if top == "fifo" and sub == "stamp":
                assert lead == (1,)  # D
            elif spread:
                assert lead == (2,), key
            else:
                assert lead == (4,), key
    assert set(WORKER_ENTRIES) - set(ROW_ENTRIES) == {("versions",)}


def test_no_guard_of_the_ring_is_left():
    src = os.path.join(REPO, "src", "repro_torch")
    for root, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert '"15c"' not in text and "_no_ring" not in text, f
                assert "_check_not_mesh_state" not in text, f
