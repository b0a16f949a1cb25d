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


def problem(name: str, steps: int = STEPS):
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
                   for _ in range(steps)]
        return mlp_loss, params, batches
    model = build_model(lm_cfg())
    ds = SyntheticLM(vocab=128, seq_len=SEQ, temperature=1.2, seed=0)
    batches = [make_worker_batches(ds, M, BATCH_PER_WORKER, t)
               for t in range(steps)]
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


# ---------------------------------------------------------------------------
# the options over the ring (tests/test_torch_ring_options.py)
# ---------------------------------------------------------------------------

# a crash of peer 3 (rank 1 at world 2, rank 3 at world 4) at step 1, dead at
# step 2 and re-admitted at step 4 from donor 0 (rank 0); a NaN in peer 2's
# queued gradient; a corrupt and a dropped wire group
CHAOS_PLAN = ("crash:peer=3,step=1,recover=4;nan:step=2,peer=2,group=0;"
              "corrupt:step=3,group=1;drop:step=5,group=0")
CHAOS_STEPS = 6
OPTION_HISTORY = HISTORY + ("peers_live",)

# the prod backend's options at M=4, R=2, D=1: name -> (problem, steps,
# kwargs)
OPTION_CASES = {
    "streams2": ("mlp", STEPS, dict(overlap=True, streams=2, use_pallas=True,
                                    straggler_delays=STRAGGLERS)),
    "streams3_int8": ("mlp", STEPS, dict(overlap=True, streams=3,
                                         use_pallas=True, wire="int8",
                                         compensate=0.5,
                                         straggler_delays=STRAGGLERS)),
    "streams3_plain": ("mlp", STEPS, dict(overlap=True, streams=3)),
    "lm_streams3_int8": ("lm", STEPS, dict(overlap=True, streams=3,
                                           use_pallas=True, wire="int8",
                                           compensate=0.5)),
    "chaos_param": ("mlp", CHAOS_STEPS, dict(use_pallas=True,
                                             faults=CHAOS_PLAN)),
    "chaos_int8_overlap": ("mlp", CHAOS_STEPS, dict(
        overlap=True, use_pallas=True, wire="int8", compensate=0.5,
        faults=CHAOS_PLAN)),
    "chaos_int8_streams3": ("mlp", CHAOS_STEPS, dict(
        overlap=True, streams=3, use_pallas=True, wire="int8",
        compensate=0.5, faults=CHAOS_PLAN)),
    "chaos_plain_streams2": ("mlp", CHAOS_STEPS, dict(
        overlap=True, streams=2, faults=CHAOS_PLAN)),
}


def _backend(name, loss_fn, group, device="cpu", **kw):
    mesh = None if group is None else WorkerMesh(M, device, group)
    return make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                        optimizer=momentum(0.9), schedule=constant(LR),
                        fb_ratio=R, update_delay=D, device=device,
                        mesh=mesh, **kw)


def _close(be):
    if be.engine is not None and hasattr(be.engine, "close"):
        be.engine.close()


def run_option(name, group, device="cpu"):
    """The prod backend with an option of ``OPTION_CASES`` on ``device``:
    the final state's rows, ``w``, ``versions`` (on the host), the
    histories and the summary."""
    prob, steps, kw = OPTION_CASES[name]
    loss_fn, params, batches = problem(prob, steps)
    be = _backend(name, loss_fn, group, device, wait_timeout_s=60.0, **kw)
    try:
        out = drive(be, batches, None, params, history_keys=OPTION_HISTORY)
        st = out["state"]
        if be.streams > 1:
            st = be.engine.materialize(st)
        return {"read": tree_map(lambda t: t.detach().cpu(), st["read"]),
                "w": st["w"].cpu(), "versions": st["versions"].cpu(),
                "history": out["history"],
                "summary": {k: v for k, v in out.items()
                            if k not in ("state", "history")}}
    finally:
        _close(be)


def _cuda_device(group) -> str:
    """A gloo group's ranks share ``cuda:0``; an nccl group's rank r holds
    ``cuda:r``."""
    import torch.distributed as dist

    return ("cuda:0" if dist.get_backend(group) == "gloo"
            else f"cuda:{dist.get_rank(group)}")


def run_cuda_option(name, group):
    """:func:`run_option` on CUDA tensors over the group (a gloo group's
    staged through pinned host buffers; the summary's ``staging_s``)."""
    return run_option(name, group, _cuda_device(group))


def run_cuda_rows(group):
    """``copy_row_`` of CUDA rows for every (src, dst) pair and
    ``gather_rows_to`` rank 0, back on the host, with the staging
    seconds."""
    dev = _cuda_device(group)
    mesh = WorkerMesh(M, dev, group)
    full = hop_full(M, "float32").to(dev)
    out = {"copies": {}}
    for src in range(M):
        for dst in range(M):
            if src != dst:
                mine = mesh.local(full).clone()
                mesh.copy_row_(mine, src, dst)
                out["copies"][(src, dst)] = mine.cpu()
    got = mesh.gather_rows_to(mesh.local(full), 0)
    out["gather"] = None if got is None else got.cpu()
    out["staging_s"] = mesh.stats["staging_s"]
    out["transport"] = mesh.transport
    return out


LIVE_POLICY = dict(min_interval_steps=2)


def run_live(overlap, group):
    """The reduced LM's prod backend with a publisher, and a ``LiveServer``
    polling it after every step: on a mesh one on each rank serving its
    first worker, on one process one for each rank's first worker. The
    decisions, the swapped steps, the served params and the snapshots'
    rows."""
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.serving import LiveServer, PlanePublisher, SwapPolicy

    loss_fn, params, batches = problem("lm", 4)
    model = build_model(lm_cfg())
    pub = PlanePublisher()
    be = _backend("live", loss_fn, group, use_pallas=True, overlap=overlap,
                  publisher=pub, measure_drift=True)
    mesh = _mesh(group)
    workers = ([mesh.rows.start] if mesh is not None
               else [r * (M // 2) for r in range(2)])
    servers = {j: LiveServer(ServeLoop(model, params, num_slots=2,
                                       max_len=16, device="cpu"),
                             None, pub, policy=SwapPolicy(**LIVE_POLICY),
                             worker=j, mesh=mesh) for j in workers}
    st = be.init(None, params)
    for srv in servers.values():
        srv.part = be.part
    rows = []
    for t, b in enumerate(batches):
        st, _ = be.step(st, b)
        rows.append(None if pub.latest().rows is None
                    else list(pub.latest().rows))
        for srv in servers.values():
            srv.poll()
    return {j: {"decisions": [(d.accepted, d.reason) for d in srv.decisions],
                "swaps": [r.step for r in srv.swaps],
                "served": _host(srv.loop.params)}
            for j, srv in servers.items()} | {"rows": rows}


def _tuning_run(path, group):
    loss_fn, params, batches = problem("mlp")
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(LR),
                      use_pallas=True, device="cpu", mesh=_mesh(group),
                      tuning=path)
    out = drive(be, batches, None, params, history_keys=HISTORY)
    sched = (be.engine.R, be.engine.D, be.engine.max_inflight_steps,
             be.overlap)
    return {"schedule": sched, "read": _host(out["state"]["read"]),
            "w": out["state"]["w"].clone(),
            "history": out["history"]}


def run_tuning(path, group):
    """The prod backend with ``tuning=path`` (a record that loads on every
    rank): the resolved schedule and the run."""
    return _tuning_run(path, group)


def run_tuning_split(path, group):
    """``tuning=`` a record that loads on rank 0 and a missing file on the
    others: what each rank raises."""
    import torch.distributed as dist

    mine = path if dist.get_rank(group) == 0 else path + ".missing"
    try:
        _tuning_run(mine, group)
        return ("none", "")
    except Exception as e:  # noqa: BLE001 - reported to the test
        return (type(e).__name__, str(e))


CKPT_AT = 2


def _state_host(st):
    return tree_map(lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else np.array(t), st)


def run_checkpoint(ckpt_dir, one_dir, group):
    """Save at step ``CKPT_AT`` (on a mesh: ``mesh=``), then one more
    step: the state saved and the step after. Restored from the archive
    into a fresh state, ``resume(CKPT_AT)``, one step: that step's state.
    On a mesh also the one-process archive under ``one_dir`` restored into
    the rank's state."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    loss_fn, params, batches = problem("mlp", CKPT_AT + 1)
    mesh = _mesh(group)
    kw = dict(use_pallas=True, wire="int8", compensate=0.5)
    be = _backend("ckpt", loss_fn, group, **kw)
    st = be.init(None, params)
    for b in batches[:CKPT_AT]:
        st, _ = be.step(st, b)
    path = save_checkpoint(ckpt_dir, CKPT_AT, st, mesh=mesh)
    saved = _state_host(st)
    st, m = be.step(st, batches[CKPT_AT])
    after = (_state_host(st), float(m["loss"]))
    be2 = _backend("ckpt", loss_fn, group, **kw)
    back = restore_checkpoint(ckpt_dir, None, be2.init(None, params),
                              mesh=mesh)
    restored = _state_host(back)
    be2.resume(CKPT_AT)
    back, m = be2.step(back, batches[CKPT_AT])
    out = {"path": path, "saved": saved, "after": after,
           "restored": restored,
           "resumed": (_state_host(back), float(m["loss"]))}
    if mesh is not None:
        out["from_one"] = _state_host(restore_checkpoint(
            one_dir, CKPT_AT, be2.init(None, params), mesh=mesh))
    return out


SERVE_DECODE_STEPS = 8


def run_serve(B, group):
    """``make_prefill_step`` and ``make_decode_step`` on the reduced LM at
    global batch ``B`` (prompts of 6 tokens, 8 greedy decode steps): the
    prefill logits, each decode step's logits and the greedy tokens."""
    model = build_model(lm_cfg())
    params = model.init(seed=0, device="cpu")
    mesh = WorkerMesh(M, "cpu", group)
    S = 6 + SERVE_DECODE_STEPS
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 128, (B, 6)).astype(np.int32))
    prefill = make_step(model, mesh, ShapeConfig("p", 6, B, "prefill"))
    decode = make_step(model, mesh, ShapeConfig("d", S, B, "decode"))
    cache, logits = prefill.fn(params, {"tokens": tokens})
    # the prefill's cache is sized to the prompt: decode into a cache of
    # S positions with the prompt's written in front
    from repro_torch.models.transformer import alloc_cache
    specs = decode.abstract_args[1]
    big = alloc_cache(specs, device="cpu")
    for (path_b, lb), la in zip(_paths(big), _leaves(cache)):
        lb.narrow(_seq_dim(lb, la), 0, la.shape[_seq_dim(lb, la)]).copy_(la)
    out = {"prefill": logits.clone(), "cache_rows": _leaves(big)[0].shape,
           "decode": [], "tokens": []}
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for i in range(SERVE_DECODE_STEPS):
        pos = torch.full((B,), 6 + i, dtype=torch.int32)
        lg, big = decode.fn(params, big, tok, pos)
        out["decode"].append(lg.clone())
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["tokens"].append(tok.clone())
    return out


def _leaves(tree):
    from repro_torch.core.pytree import tree_leaves
    return tree_leaves(tree)


def _paths(tree):
    from repro_torch.core.pytree import tree_flatten_with_path
    return [(p, x) for p, x in tree_flatten_with_path(tree)[0]]


def _seq_dim(big, small) -> int:
    """The one dim where a cache leaf of S positions and the prefill's of
    the prompt's differ (0 where they do not)."""
    for d, (a, b) in enumerate(zip(big.shape, small.shape)):
        if a != b:
            return d
    return 0


MAKE_STEP_CASES = {
    "streams2_faults": dict(fb_ratio=R, update_delay=D, use_pallas=True,
                            overlap=True, streams=2,
                            faults="crash:peer=1,step=0,recover=3"),
    "faults_int8": dict(fb_ratio=R, update_delay=D, use_pallas=True,
                        wire="int8", compensate=0.5,
                        faults="crash:peer=2,step=0,recover=3"),
}
MAKE_STEP_STEPS = 4


def run_make_step_option(name, path, group):
    """``make_step``'s decoupled step on the reduced LM with an option of
    ``MAKE_STEP_CASES`` (``"tuning"``: ``tuning=path``), the chaos
    controller run before each step: the final rows, ``w``, ``versions``,
    the losses and the controller's summary."""
    _, params, batches = problem("lm", MAKE_STEP_STEPS)
    model = build_model(lm_cfg())
    kw = dict(tuning=path) if name == "tuning" else MAKE_STEP_CASES[name]
    step = make_step(model, WorkerMesh(M, "cpu", group),
                     ShapeConfig("t", SEQ, M * BATCH_PER_WORKER, "train"),
                     optimizer=momentum(0.9), schedule=constant(LR), **kw)
    stacked = tree_map(lambda x: x[None].expand((M,) + tuple(x.shape)),
                       params)
    st = step.init_state(stacked)
    losses = []
    try:
        for t, b in enumerate(_global_batches(batches)):
            if step.chaos is not None:
                st, b = step.chaos.before_step(st, b, t)
            st, m = step.fn(st, b, t, t % 2)
            losses.append(float(m["loss"]))
        engine = getattr(step, "engine", None)
        if engine is not None and hasattr(engine, "materialize"):
            st = engine.materialize(st)
        return {"read": _host(st["read"]), "w": st["w"].clone(),
                "versions": st["versions"].clone(), "losses": losses,
                "chaos": None if step.chaos is None
                else step.chaos.summary()}
    finally:
        engine = getattr(step, "engine", None)
        if engine is not None and hasattr(engine, "close"):
            engine.close()


def run_chaos_state(spec, damp, state_path, steps, group):
    """The chaos controller over ``steps`` step boundaries on the numpy
    state of M workers saved at ``state_path``
    (``tests/test_torch_chaos.py::_np_state``): on a mesh the rank's rows
    of the row entries, the rest whole. The rank's state after every step
    and the summary."""
    from repro_torch.chaos import ChaosController
    from repro_torch.launch.mesh import ROW_ENTRIES

    state = torch.load(state_path, weights_only=False)
    Mc = len(state["w"])
    mesh = WorkerMesh(Mc, "cpu", group)

    def take(path, tree):
        if isinstance(tree, dict):
            return {k: take(path + (k,), v) for k, v in tree.items()}
        t = torch.from_numpy(np.array(tree))
        spread = any(path[:len(e)] == e for e in ROW_ENTRIES)
        return mesh.local(t).clone() if spread and t.dim() else t

    st = {k: take((k,), v) for k, v in state.items() if k != "alive"}
    st["alive"] = np.array(state["alive"])
    ctl = ChaosController(spec, Mc, update_delay=1, compensate=damp,
                          mesh=mesh)
    trace = []
    for t in range(steps):
        st, _ = ctl.before_step(st, None, t)
        trace.append(_state_host(st))
    return {"trace": trace, "summary": ctl.summary()}


def run_primitives(group):
    """The mesh's row copy, gather and agreement at M=4 on CPU tensors:
    ``copy_row_`` for every (src, dst) pair, ``gather_rows_to`` rank 0 and
    the last rank, ``agree`` on equal and on different values, and a
    ``LiveServer`` of another rank's worker."""
    import torch.distributed as dist
    from repro_torch.serving import LiveServer, PlanePublisher

    mesh = WorkerMesh(M, "cpu", group)
    full = hop_full(M, "float32")
    out = {"copies": {}}
    for src in range(M):
        for dst in range(M):
            if src != dst:
                mine = mesh.local(full).clone()
                mesh.copy_row_(mine, src, dst)
                out["copies"][(src, dst)] = mine
    out["gather"] = [mesh.gather_rows_to(mesh.local(full), r)
                     for r in (0, mesh.world - 1)]
    out["agree_same"] = mesh.agree({"R": 2, "D": [1, None]}, "schedules")
    try:
        mesh.agree(dist.get_rank(group), "ranks")
        out["agree_differ"] = ("none", "")
    except Exception as e:  # noqa: BLE001 - reported to the test
        out["agree_differ"] = (type(e).__name__, str(e))
    other = (mesh.rows.stop) % M
    try:
        LiveServer(None, None, PlanePublisher(), worker=other, mesh=mesh)
        out["live_other"] = ("none", "")
    except Exception as e:  # noqa: BLE001 - reported to the test
        out["live_other"] = (type(e).__name__, str(e))
    out["stats"] = dict(mesh.stats)
    return out


def run_entries(group):
    """The leading dim of every leaf of a ranked decoupled state (int8
    wire, λ 0.5, D=1), by its key path."""
    from repro_torch.checkpoint.checkpoint import keystr
    from repro_torch.core.pytree import tree_flatten_with_path

    loss_fn, params, _ = problem("mlp")
    be = _backend("entries", loss_fn, group, use_pallas=True, wire="int8",
                  compensate=0.5)
    st = be.init(None, params)
    return {keystr(p): (tuple(x.shape)[:1] if hasattr(x, "shape") else ())
            for p, x in tree_flatten_with_path(st)[0]}


JOBS = {"backend": run_backend, "route": run_route, "hops": run_hops,
        "jax": run_jax_case, "checks": run_checks,
        "cuda_hops": run_cuda_hops, "option": run_option, "live": run_live,
        "tuning": run_tuning, "tuning_split": run_tuning_split,
        "checkpoint": run_checkpoint, "serve": run_serve,
        "make_step": run_make_step_option, "chaos_state": run_chaos_state,
        "primitives": run_primitives, "entries": run_entries,
        "cuda_option": run_cuda_option, "cuda_rows": run_cuda_rows}


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
