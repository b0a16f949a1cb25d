"""The multi-process worker ring (``WorkerMesh`` with a ``torch.distributed``
group) against the one-process stacked step, on the CPU over ``gloo``.

Ranks are spawned with ``torch.multiprocessing``, one torch thread each,
and join their group through a file store under the test's temporary
directory (no port to clash on between test workers). Each module fixture
makes one spawn that runs all its scenarios (``tests/_torch_ring_worker.py``)
while this process computes the one-process runs they are held to, on one
torch thread too.

* (a) ``ring_hop`` of each rank's rows equals ``torch.roll(full, s,
  0)[rows]`` bit for bit: world 2 and 4, M 4 and 8, every shift, float32,
  bfloat16 and int8 buffers.
* (b) The prod backend at M=4 (R=2, D=1, straggler delays) over world 2
  (L=2) and world 4 (L=1): the read and write planes, ``w``, ``versions``,
  the loss, skip, weight-sum and staleness histories bit for bit against
  the one-process M=4 step, over the monolithic step and ``overlap=True``,
  the fused and plain routes, the param wire and the int8 wire with λ=0.5;
  the disagreement within rtol 1e-6; the wire bytes are what crossed.
* (c) ``make_step``'s decoupled (also ``overlap=True`` on the int8 wire)
  and lockstep routes over world 2 bit for bit against the one-process
  mesh; DDP within rtol 1e-5 of one replica over the global batch.
* (d) The reduced dense LM at M=4 over world 2 (fused, int8 wire, λ=0.5)
  against the JAX package's ``ProdTrainerBackend`` on a (4, 1) CPU host
  mesh, at ``test_torch_train_multiworker.py``'s tolerances.
* (e) An uneven split and an ``nccl`` group on the CPU raise
  ``ValueError``; the backend's mesh arguments are checked. The options
  that run over the ring (streams, faults, publisher, tuning, prefill and
  decode, checkpoints) are held in ``tests/test_torch_ring_options.py``.
"""
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
if not dist.is_available() or not dist.is_gloo_available():
    pytest.skip("torch.distributed with gloo is needed", allow_module_level=True)

import numpy as np  # noqa: E402

import _torch_ring_worker as W  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import WorkerMesh  # noqa: E402

DRIFT_RTOL = 1e-6
DDP_RTOL = 1e-5
# the histories held bit for bit (the disagreement sums in another order)
EXACT = tuple(k for k in W.HISTORY if k != "disagreement")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, one_thread):
    """World 2: the hops, the backend cases, the ``make_step`` routes and
    the mesh checks; meanwhile the one-process backend runs and routes."""
    jobs = ([("hops",), ("checks",)]
            + [("backend", c) for c in W.BACKEND_CASES]
            + [("route", r) for r in W.ROUTES])

    def one_process():
        return ({c: W.run_backend(c, None) for c in W.BACKEND_CASES},
                {r: W.run_route(r, None) for r in W.ROUTES})

    ranks, (backend, routes) = W.spawn(
        2, str(tmp_path_factory.mktemp("ring2")), jobs, one_process)
    return {"ranks": ranks, "backend": backend, "routes": routes}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, world2):
    """World 4: the hops and the backend cases."""
    jobs = [("hops",)] + [("backend", c) for c in W.BACKEND_CASES]
    ranks, _ = W.spawn(4, str(tmp_path_factory.mktemp("ring4")), jobs)
    return {"ranks": ranks, "backend": world2["backend"]}


def _world(request, world):
    return request.getfixturevalue(f"world{world}")


# ---------------------------------------------------------------------------
# (a) the ring hop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("Mh", [4, 8])
@pytest.mark.parametrize("dtype", list(W.HOP_DTYPES))
def test_ring_hop_equals_roll(request, world, Mh, dtype):
    ranks = _world(request, world)["ranks"]
    full = W.hop_full(Mh, dtype)
    for rank, res in enumerate(ranks):
        rows, got = res[("hops",)][(Mh, dtype)]
        L = Mh // world
        assert rows == list(range(rank * L, (rank + 1) * L))
        for s, g in zip(range(1, Mh), got):
            want = torch.roll(full, s, 0)[rows[0]:rows[-1] + 1]
            assert g.dtype == want.dtype and torch.equal(g, want), (rank, s)


def test_ring_hop_without_group_is_roll():
    full = W.hop_full(4, "float32")
    mesh = WorkerMesh(4, "cpu")
    for s in range(1, 4):
        assert torch.equal(mesh.ring_hop(full, s), torch.roll(full, s, 0))
    assert mesh.local(full) is full and mesh.world == 1
    assert mesh.all_gather_rows(full) is full
    assert mesh.all_reduce_sum_(full) is full


# ---------------------------------------------------------------------------
# (b) the prod backend over the ring
# ---------------------------------------------------------------------------


def _gathered(ranks, key, case):
    """The ranks' rows of a plane, concatenated in rank order."""
    parts = [r[("backend", case)][key] for r in ranks]
    return {g: torch.cat([p[g] for p in parts]) for g in parts[0]}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", W.BACKEND_CASES, ids=W.case_id)
def test_backend_over_ring_matches_one_process(request, world, case):
    run = _world(request, world)
    want = run["backend"][case]
    for key in ("read", "write"):
        got = _gathered(run["ranks"], key, case)
        assert got.keys() == want[key].keys()
        for g, v in want[key].items():
            assert torch.equal(got[g], v), (key, g)
    for rank, res in enumerate(run["ranks"]):
        mine = res[("backend", case)]
        assert torch.equal(mine["w"], want["w"]), rank
        assert torch.equal(mine["versions"], want["versions"]), rank
        for k in EXACT:
            np.testing.assert_array_equal(mine["history"][k],
                                          want["history"][k], err_msg=k)
        np.testing.assert_allclose(mine["history"]["disagreement"],
                                   want["history"]["disagreement"],
                                   rtol=DRIFT_RTOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("wire", ["param", "int8"])
def test_backend_wire_bytes_are_what_crossed(request, world, wire):
    """``wire_bytes_per_round`` is this rank's bytes sent to other ranks
    over the run's rounds: a row crosses where the shift sends it to
    another rank, and carries one plane of the wire's bytes."""
    case = ("mlp", False, True, wire, 0.5 if wire == "int8" else 0.0)
    ranks = _world(request, world)["ranks"]
    draws = np.random.default_rng(0xC0FFEE)
    shifts = [(1, 2)[int(draws.integers(0, 2))] for _ in range(W.STEPS)]
    L = W.M // world
    for rank, res in enumerate(ranks):
        mine = res[("backend", case)]
        crossed = sum((rank * L + k + s) % W.M // L != rank
                      for s in shifts for k in range(L))
        per_round = crossed * mine["plane_bytes"][wire] / W.STEPS
        assert mine["summary"]["wire_bytes_per_round"] == per_round
        assert mine["summary"]["staging_s"] == 0.0  # gloo on CPU tensors


# ---------------------------------------------------------------------------
# (c) make_step's training routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", W.ROUTES)
def test_make_step_route_over_ring(world2, route):
    want = world2["routes"][route]
    mine = [r[("route", route)] for r in world2["ranks"]]
    if route == "ddp":
        # every rank holds the replica: one over the global batch
        for res in mine:
            for g, w in zip(tree_leaves(res["params"]),
                            tree_leaves(want["params"])):
                torch.testing.assert_close(g, w, rtol=DDP_RTOL, atol=1e-7)
            torch.testing.assert_close(torch.stack(res["losses"]),
                                       torch.stack(want["losses"]),
                                       rtol=DDP_RTOL, atol=0.0)
        return
    for i, w in enumerate(tree_leaves(want["params"])):
        got = torch.cat([tree_leaves(res["params"])[i] for res in mine])
        assert torch.equal(got, w), i
    for res in mine:
        assert torch.equal(res["w"], want["w"])
        assert torch.equal(torch.stack(res["losses"]),
                           torch.stack(want["losses"]))
        if "versions" in want:
            assert torch.equal(res["versions"], want["versions"])


# ---------------------------------------------------------------------------
# (d) against the JAX package
# ---------------------------------------------------------------------------

JAX_CASE = ("lm", 4, 2, 1, True, "int8", 0.5)


@pytest.fixture(scope="module")
def jax_ring(tmp_path_factory, one_thread):
    from test_torch_train_multiworker import _bench_torch_cfg, _parse_case
    from test_torch_train_multiworker import _run_reference

    assert W.lm_cfg() == _bench_torch_cfg()
    tmp = tmp_path_factory.mktemp("ring_jax")
    ref = _run_reference(tmp / "ref.npz", [JAX_CASE])
    tag = _parse_case(JAX_CASE)[-1]
    from _torch_parity import METRICS
    ranks, _ = W.spawn(2, str(tmp / "ranks"),
                       [("jax", JAX_CASE, str(tmp / "ref.npz"), tag,
                         METRICS)])
    return ref, tag, [r[("jax", JAX_CASE, str(tmp / "ref.npz"), tag,
                         METRICS)] for r in ranks]


def test_ring_matches_jax_prod_backend(jax_ring):
    from _torch_parity import METRICS, compare_metrics
    from repro_torch.convert import unflatten_npz
    from test_torch_train_multiworker import _int8_close

    ref, tag, ranks = jax_ring
    for res in ranks:
        for t in range(W.STEPS):
            compare_metrics({k: res["history"][k][t] for k in METRICS},
                            {k: ref[tag + f"metric{t}/{k}"]
                             for k in METRICS}, t)
    read = {g: torch.cat([r["read"][g] for r in ranks])
            for g in ranks[0]["read"]}
    _int8_close(read, unflatten_npz(ref, tag + "read"), 1e-4)


# ---------------------------------------------------------------------------
# (e) the mesh's checks
# ---------------------------------------------------------------------------


def test_mesh_checks_over_two_ranks(world2):
    """``workers % world != 0`` and an ``nccl`` group on the CPU raise
    ``ValueError``; ranks that draw different gossip shifts are refused at
    ``init``; the layout and transport of a gloo mesh."""
    for rank, res in enumerate(world2["ranks"]):
        checks = res[("checks",)]
        assert checks["uneven"][0] == "ValueError"
        assert "workers % world" in checks["uneven"][1]
        assert checks["nccl_on_cpu"][0] == "ValueError"
        assert "nccl" in checks["nccl_on_cpu"][1]
        assert checks["layout"] == (2, rank, 2, [2 * rank, 2 * rank + 1],
                                    "gloo")
        assert checks["shift_draws"][0] == "RuntimeError"
        assert "different gossip shifts" in checks["shift_draws"][1]


@pytest.fixture(scope="module")
def solo_group(tmp_path_factory):
    """A one-rank gloo group in this process, for the argument checks."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    store = tmp_path_factory.mktemp("solo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_backend_mesh_arguments(solo_group):
    """The mesh's worker count must be M, and a ``device`` that differs
    from the mesh's raises; a mesh without a group is the one-process
    backend."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    kw = dict(loss_fn=W.mlp_loss, optimizer=momentum(0.9),
              schedule=constant(0.1))
    with pytest.raises(ValueError, match="M=4"):
        make_backend("prod", "layup", M=4, mesh=WorkerMesh(2, "cpu",
                                                            solo_group),
                     **kw)
    with pytest.raises(ValueError, match="differs"):
        make_backend("prod", "layup", M=2, device="cpu",
                     mesh=WorkerMesh(2, "meta", solo_group), **kw)
    be = make_backend("prod", "layup", M=2, mesh=WorkerMesh(2, "cpu"), **kw)
    assert be.mesh is None and be.device == torch.device("cpu")
