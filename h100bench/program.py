"""The system under test, driven as a user drives it: the PyTorch/CUDA
port's prod backend (``repro_torch.core.backend.make_backend("prod",
"layup", ...)``), one ``ProdTrainerBackend.step`` call a step.

Everything a cell varies comes from its traffic file: workers, forward
slices (``fb_ratio``), FIFO depth, wire, compensation, streams, optimizer
and learning rate; the model from its configuration file. Every other
argument keeps the backend's default.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from h100bench import inputs
from h100bench.reference.pdasgd import leaf_norm


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    fields = dict(config["model"])
    fields["dtype"] = getattr(torch, fields["dtype"])
    fields.pop("ssd_chunk", None)  # the reference's own chunking
    return ModelConfig(name=config["name"], **fields)


def build(config: dict, traffic: dict, device):
    """(model, backend) of a cell."""
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    model = build_model(model_config(config))
    opt = traffic["optimizer"]
    if opt["name"] != "momentum":
        raise ValueError(f"unsupported optimizer {opt['name']!r}")
    streams = int(traffic["streams"])
    extra = {"overlap": True, "streams": streams} if streams > 1 else {}
    backend = make_backend(
        "prod", traffic["algo"], M=traffic["workers"],
        loss_fn=model.loss_fn, optimizer=momentum(opt["beta"]),
        schedule=constant(traffic["lr"]), fb_ratio=traffic["fb_ratio"],
        update_delay=traffic["update_delay"], use_pallas=True,
        device=device, wire=traffic["wire"],
        compensate=traffic["compensate"], **extra)
    return model, backend


def param_shapes(model) -> Dict[str, tuple]:
    return {p: tuple(t.shape)
            for p, t in inputs.flatten(model.abstract_params()).items()}


def settle(backend) -> None:
    """Wait until the backend's work is done: the stream engine's tasks
    launched and their spans recorded, then the device idle."""
    if backend.engine is not None and getattr(backend, "streams", 1) > 1:
        backend.engine.finalize()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def materialize(backend, tree):
    eng = backend.engine
    return eng.materialize(tree) if hasattr(eng, "materialize") else tree


def per_leaf(backend, planes) -> Dict[str, List[torch.Tensor]]:
    """{path: [worker m's leaf]} of a stacked plane dict of the program."""
    tree = backend.part.unpack(materialize(backend, planes))
    return {p: list(v.unbind(0)) for p, v in inputs.flatten(tree).items()}


def first_steps(backend, box, batches, weights, steps: int, D: int,
                keep: Optional[dict] = None):
    """Run the first ``steps`` steps through the window's own call and
    feed, reading what the correctness check compares: each step's loss,
    the momentum after step D (the first gradient the optimizer got), each
    leaf's change from ``weights`` after the last step, the clocks and
    the push-sum weights. ``box["state"]`` holds the state: a step consumes
    its state, so no other reference to it may stay alive. ``keep``, where
    given, receives each leaf's parameters after the last step (all
    workers, on the host)."""
    out = {"loss": []}
    for t in range(steps):
        box["state"], metrics = backend.step(box["state"], batches[t])
        out["loss"].append(float(metrics["loss"]))
        if t == D:
            out["grad_norms"] = {
                p: [leaf_norm(v) for v in vs]
                for p, vs in per_leaf(backend, box["state"]["opt"]).items()}
    read = inputs.flatten(backend.export_params(box["state"]))
    out["update_norms"] = {
        p: [leaf_norm(v[m].to(torch.float32) - weights[p].to(torch.float32))
            for m in range(v.shape[0])] for p, v in read.items()}
    if keep is not None:
        keep.update({p: v.cpu() for p, v in read.items()})
    del read
    out["versions"] = materialize(backend, box["state"]["versions"]).cpu()
    out["w"] = materialize(backend, box["state"]["w"]).cpu()
    settle(backend)
    return out


def step(backend, box, batches) -> None:
    """One step on the next batch of the cycle (``box["t"]`` counts the
    steps); its loss is kept in ``box["losses"]``."""
    box["state"], metrics = backend.step(
        box["state"], batches[box["t"] % len(batches)])
    box["losses"].append(metrics["loss"])
    box["t"] += 1


def drive(backend, box, batches, seconds: float, t0=None):
    """Steps back to back until ``seconds`` have passed since ``t0`` (now,
    by default), then wait for the device. Returns (steps, elapsed)."""
    t0 = time.perf_counter() if t0 is None else t0
    n = 0
    while time.perf_counter() - t0 < seconds:
        step(backend, box, batches)
        n += 1
    settle(backend)
    return n, time.perf_counter() - t0


def close(backend) -> None:
    eng = backend.engine
    if eng is not None and hasattr(eng, "close"):
        eng.close()
