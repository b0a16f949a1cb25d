"""The scenarios of the multi-process worker ring (``WorkerMesh`` with a
``gloo`` group on the CPU), run on every rank of a spawned group by
``tests/test_torch_ring.py`` and, with ``group=None``, as the one-process
stacked step they are held to.

This module imports torch and the port only (no jax, nothing of the JAX
package), so a spawned rank starts in seconds. Each rank runs on one torch
thread; the one-process runs must too, for the same bits.
"""
import datetime
import os

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import to_torch, unflatten_npz
from repro_torch.core.backend import drive, make_backend
from repro_torch.core.pytree import tree_map
from repro_torch.data.synthetic import SyntheticLM, make_worker_batches
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.launch.train import make_step
from repro_torch.models import build_model
from repro_torch.optim import constant, momentum

M = 4
STEPS = 3
R, D = 2, 1
LR = 0.05
SEQ, BATCH_PER_WORKER = 16, 4
STRAGGLERS = (0, 1, 0, 2)
HISTORY = ("loss", "update_staleness", "layer_staleness", "weight_sum",
           "disagreement", "staleness_mean", "nonfinite_skips")
HOP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}

# (problem, overlap, use_pallas, wire, compensate): the prod backend at M=4,
# R=2, D=1 with straggler delays; the MLP over the whole grid, the decoder
# over one case a route
BACKEND_CASES = [("mlp", overlap, pallas, wire, comp)
                 for overlap in (False, True) for pallas in (True, False)
                 for wire, comp in (("param", 0.0), ("int8", 0.5))] + [
    ("lm", False, True, "param", 0.0), ("lm", True, True, "int8", 0.5),
    ("lm", False, False, "int8", 0.5), ("lm", True, False, "param", 0.0)]
# make_step's training routes on the decoder (global batch M·B)
ROUTES = ("decoupled", "decoupled_overlap", "lockstep", "lockstep_pallas",
          "ddp")


def case_id(case) -> str:
    return "-".join(str(c) for c in case)


def lm_cfg() -> ModelConfig:
    """The port's copy of ``benchmarks/table3_lm.py::_bench_cfg`` (float32)."""
    return ModelConfig(name="bench-lm", family="dense", num_layers=2,
                       d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
                       vocab_size=128, tie_embeddings=True,
                       dtype=torch.float32)


def mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["l1"])
    logits = h @ p["l2"]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(logp[torch.arange(logits.shape[0]), b["labels"].long()])
    return ce, {}


def problem(name: str):
    """``(loss_fn, params, batches)`` of a problem, seeded (sim layout:
    a leading ``(M,)`` worker axis on every batch leaf)."""
    rng = np.random.default_rng(7)
    if name == "mlp":
        params = {"l1": torch.from_numpy(
                      rng.standard_normal((16, 32)).astype(np.float32) * 0.2),
                  "l2": torch.from_numpy(
                      rng.standard_normal((32, 10)).astype(np.float32) * 0.2)}
        batches = [{"x": rng.standard_normal((M, 8, 16)).astype(np.float32),
                    "labels": rng.integers(0, 10, (M, 8)).astype(np.int32)}
                   for _ in range(STEPS)]
        return mlp_loss, params, batches
    model = build_model(lm_cfg())
    ds = SyntheticLM(vocab=128, seq_len=SEQ, temperature=1.2, seed=0)
    batches = [make_worker_batches(ds, M, BATCH_PER_WORKER, t)
               for t in range(STEPS)]
    return model.loss_fn, model.init(seed=0, device="cpu"), batches


def _mesh(group):
    return None if group is None else WorkerMesh(M, "cpu", group)


def _host(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def run_backend(case, group):
    """The prod backend's run of a case: the final state's rows (the rank's
    on a mesh), ``w``, ``versions``, the metric histories and the
    summary."""
    name, overlap, pallas, wire, comp = case
    loss_fn, params, batches = problem(name)
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(LR),
                      fb_ratio=R, update_delay=D,
                      straggler_delays=STRAGGLERS, use_pallas=pallas,
                      wire=wire, compensate=comp, overlap=overlap,
                      device="cpu", mesh=_mesh(group))
    out = drive(be, batches, None, params, history_keys=HISTORY)
    st = out["state"]
    return {"read": _host(st["read"]), "write": _host(st["write"]),
            "w": st["w"].clone(), "versions": st["versions"].clone(),
            "history": out["history"],
            "summary": {k: v for k, v in out.items()
                        if k not in ("state", "history")},
            "plane_bytes": {w: be.part.plane_nbytes(wire=w)
                            for w in ("param", "int8")}}


def _global_batches(batches):
    """Sim-layout ``(M, B, ...)`` batches as global ``(M·B, ...)`` ones:
    worker m's shard is rows ``[m·B, (m+1)·B)``."""
    return [{k: v.reshape((-1,) + v.shape[2:]) for k, v in b.items()}
            for b in batches]


def run_route(route, group):
    """One of ``make_step``'s training routes on the decoder at global
    batch M·B over ``STEPS`` steps: the final params (rows on a mesh),
    the push-sum weights where there are some, and the losses."""
    loss_fn, params, batches = problem("lm")
    model = build_model(lm_cfg())
    mesh = WorkerMesh(M, "cpu", group)
    batches = _global_batches(batches)
    kw = {"decoupled": dict(fb_ratio=R, update_delay=D, use_pallas=True),
          "decoupled_overlap": dict(fb_ratio=R, update_delay=D,
                                    use_pallas=True, wire="int8",
                                    compensate=0.5, overlap=True),
          "lockstep": {}, "lockstep_pallas": dict(use_pallas=True),
          "ddp": dict(algo="ddp")}[route]
    step = make_step(model, mesh, ShapeConfig("t", SEQ, M * BATCH_PER_WORKER,
                                              "train"),
                     optimizer=momentum(0.9), schedule=constant(LR), **kw)
    shift_rng = np.random.default_rng(11)
    shift = [int(shift_rng.integers(0, 2)) for _ in range(STEPS)]
    stacked = tree_map(lambda x: x[None].expand((M,) + tuple(x.shape)),
                       params)
    losses = []
    if route == "ddp":
        p, opt = step.init_state(params)
        for t, b in enumerate(batches):
            p, opt, loss = step.fn(p, opt, b, t)
            losses.append(loss.clone())
        return {"params": _host(p), "losses": losses}
    if route.startswith("lockstep"):
        p, opt, w = step.init_state(stacked)
        for t, b in enumerate(batches):
            p, opt, w, loss = step.fn(p, opt, w, b, t, shift[t])
            losses.append(loss.clone())
        return {"params": _host(p), "w": w.clone(), "losses": losses}
    st = step.init_state(stacked)
    for t, b in enumerate(batches):
        st, m = step.fn(st, b, t, shift[t])
        losses.append(m["loss"].clone())
    return {"params": _host(st["read"]), "w": st["w"].clone(),
            "versions": st["versions"].clone(), "losses": losses}


def hop_full(Mh: int, dtype: str) -> torch.Tensor:
    """The ``(Mh, 5, 3)`` buffer that the ring-hop cases roll."""
    full = torch.arange(Mh * 15, dtype=torch.int64).reshape(Mh, 5, 3)
    return ((full * 37) % 251 - 125).to(HOP_DTYPES[dtype])


def run_hops(group):
    """``ring_hop`` of this rank's rows at every shift, for M in {4, 8}
    (where they split over the ranks) and each dtype: ``{(M, dtype):
    (rows, [got at s=1..M-1])}``."""
    out = {}
    for Mh in (4, 8):
        mesh = WorkerMesh(Mh, "cpu", group)
        for dt in HOP_DTYPES:
            full = hop_full(Mh, dt)
            out[(Mh, dt)] = (list(mesh.rows), [
                mesh.ring_hop(mesh.local(full), s) for s in range(1, Mh)])
    return out


def run_jax_case(case, npz_path, tag, keys, group):
    """The prod backend on the JAX reference's params and batches (the
    ``.npz`` of ``tests/test_torch_train_multiworker.py``'s reference run,
    entries under ``tag``): the histories of ``keys`` and the read plane's
    rows."""
    name, Mc, Rc, Dc, pallas, wire, comp = case
    ref = dict(np.load(npz_path))
    params = unflatten_npz(ref, tag + "params")
    batches = [unflatten_npz(ref, tag + f"batch{t}") for t in range(STEPS)]
    model = build_model(lm_cfg())
    be = make_backend("prod", "layup", M=Mc, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=Rc, update_delay=Dc, use_pallas=pallas,
                      wire=wire, compensate=comp, device="cpu",
                      mesh=WorkerMesh(Mc, "cpu", group))
    out = drive(be, batches, None, to_torch(params, "cpu"),
                history_keys=tuple(keys))
    return {"history": out["history"], "read": _host(out["state"]["read"])}


class _NcclNamed(WorkerMesh):
    """A mesh whose group reports the ``nccl`` backend (there is no NCCL
    on the CPU): the argument check alone."""

    @property
    def backend(self):
        return "nccl"


def run_checks(group):
    """The mesh's argument checks and layout on this rank: ``{check:
    (exception type, message)}`` and ``layout``."""
    out = {}
    for key, make in (("uneven", lambda: WorkerMesh(3, "cpu", group)),
                      ("nccl_on_cpu", lambda: _NcclNamed(4, "cpu", group))):
        try:
            make()
            out[key] = ("none", "")
        except Exception as e:  # noqa: BLE001 - reported to the test
            out[key] = (type(e).__name__, str(e))
    mesh = WorkerMesh(4, "cpu", group)
    out["layout"] = (mesh.world, mesh.rank, mesh.local_workers,
                     list(mesh.rows), mesh.transport)
    # ranks that would draw different gossip shifts (rank 0 from two
    # shifts, the others from one) are refused at init
    loss_fn, params, _ = problem("mlp")
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(LR),
                      shifts=(1, 2) if mesh.rank == 0 else (1,),
                      device="cpu", mesh=mesh)
    try:
        be.init(None, params)
        out["shift_draws"] = ("none", "")
    except Exception as e:  # noqa: BLE001 - reported to the test
        out["shift_draws"] = (type(e).__name__, str(e))
    return out


def run_cuda_hops(group):
    """``ring_hop`` of this rank's rows of CUDA tensors, back on the host:
    ``{(M, dtype): (rows, [got at s=1..M-1])}``, the transport and the
    staging seconds. A gloo group's ranks share ``cuda:0`` (its tensors
    staged through pinned host buffers); an nccl group's rank r holds
    ``cuda:r``."""
    import torch.distributed as dist

    dev = ("cuda:0" if dist.get_backend(group) == "gloo"
           else f"cuda:{dist.get_rank(group)}")
    out = {}
    for Mh in (4, 8):
        mesh = WorkerMesh(Mh, dev, group)
        for dt in HOP_DTYPES:
            full = hop_full(Mh, dt).to(dev)
            out[(Mh, dt)] = (list(mesh.rows), [
                mesh.ring_hop(mesh.local(full), s).cpu()
                for s in range(1, Mh)])
        out["transport"] = mesh.transport
        out["staging_s"] = mesh.stats["staging_s"]
    return out


def direct_gloo_cuda_p2p(rank, world, store, out_dir):
    """One rank of the probe of gloo's point-to-point ops on CUDA tensors
    handed to it directly (no staging): each rank sends a 16-element
    tensor on ``cuda:0`` to the other and receives one. Writes the outcome
    ("delivered", "wrong bits" or the exception) to ``probe<rank>.txt``;
    a crash writes nothing."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=30))
    mine = torch.full((16,), float(rank + 1), device="cuda:0")
    got = torch.zeros(16, device="cuda:0")
    peer = 1 - rank
    try:
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, mine, peer),
                dist.P2POp(dist.irecv, got, peer)]):
            req.wait()
        outcome = ("delivered" if bool((got.cpu() == peer + 1).all())
                   else "wrong bits")
    except Exception as e:  # noqa: BLE001 - the outcome is the reading
        outcome = f"raised {type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"probe{rank}.txt"), "w") as f:
        f.write(outcome)
    dist.destroy_process_group()


JOBS = {"backend": run_backend, "route": run_route, "hops": run_hops,
        "jax": run_jax_case, "checks": run_checks,
        "cuda_hops": run_cuda_hops}


def rank_main(rank, world, store, out_dir, jobs, backend="gloo"):
    """One rank: join the group (``backend``; nccl on ``cuda:rank``)
    through the file store, run every job, save ``{job: result}`` as
    ``rank<rank>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for job in jobs:
            results[job] = JOBS[job[0]](*job[1:], dist.group.WORLD)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, tmp_dir: str, jobs, while_running=None,
          backend: str = "gloo"):
    """Run ``jobs`` on ``world`` spawned ranks of a ``backend`` group;
    ``while_running()``, when given, runs in this process meanwhile.
    Returns ``(per-rank results, while_running's result)``."""
    import torch.multiprocessing as mp

    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    ctx = mp.spawn(rank_main,
                   args=(world, store, tmp_dir, list(jobs), backend),
                   nprocs=world, join=False)
    try:
        mine = while_running() if while_running is not None else None
    finally:
        while not ctx.join():
            pass
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False)
            for r in range(world)], mine
