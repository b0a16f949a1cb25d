"""The harness's run of a cell on the CPU at tiny widths: the plain
reference follows the port step for step; the harness's look for a card is
skipped, and with the timed path broken underneath, ``correct`` comes out
false; the low-precision control fails the cell's limits."""
import time

import pytest
import torch

from h100bench import check
from h100bench.control import readings
from h100bench.run import run_cell
from h100bench.spec import load_cell

TINY = {"dense": dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                      head_dim=16, d_ff=64, vocab_size=128),
        "ssm": dict(num_layers=1, d_model=32, ssm_state=16, ssm_head_dim=16,
                    vocab_size=128, ssd_chunk=16)}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as a checker's seeds may be
# a cell that BENCHMARK.json leaves out while its files and its reference
# stay (its rate follows the host's speed: PERF.md, Open questions)
LEFT_OUT = {"mamba2-layup-param": {
    "name": "mamba2-layup-param", "config": "mamba2-780m",
    "traffic": "pdasgd-param-8x2048", "chips": 1}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one torch thread is the fastest, and the suite's
    workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cell, traffic=None, **model):
    """A cell at tiny widths, 4 sequences a worker; ``traffic`` overrides
    the job (the int8 wire, the stream engine)."""
    spec = load_cell(cell, cell=LEFT_OUT.get(cell))
    m = spec["config"]["model"]
    m.update(TINY[m["family"]], **model)
    spec["traffic"].update(distinct_batches=4, sequences_per_worker=4,
                           sequence_length=32 if m["family"] == "ssm"
                           else 16, **(traffic or {}))
    return spec


def run(spec, seed=SEED):
    return run_cell(spec, seed, 0.05, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell, traffic, model", [
    ("gpt2m-layup-param", {}, {}),
    ("gpt2m-layup-param", {"wire": "int8", "compensate": 0.5}, {}),
    ("gpt2m-layup-param", {"streams": 3}, {}),
    ("mamba2-layup-param", {}, {"dtype": "float32"}),
], ids=["param", "int8", "streams", "mamba2"])
def test_reference_follows_the_port(cell, traffic, model):
    out = run(tiny(cell, traffic, **model))
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    got = {k: v["value"] for k, v in out["checks"].items()}
    # float32 on the CPU: the two sides differ by rounding alone
    assert got["loss_gap"] < 1e-6 and got["grad_gap"] < 1e-5
    assert got["update_gap"] < 1e-4 and got["clock_mismatch"] == 0


def _no_mix(x, r, u, a, b, out=None):
    """The step's state left unchanged: the write plane kept as it was."""
    return x if out is None else out.copy_(x)


def _no_exchange(x, r, u, a, b, out=None):
    """Nothing received: each worker applies its own update alone."""
    from repro_torch.kernels.ref import gossip_mix_ref
    return gossip_mix_ref(x, x, u, 1.0, 0.0, out=out)


def _half_batch(monkeypatch):
    import dataclasses

    import repro_torch.models as models
    build = models.build_model

    def halved(cfg):
        model = build(cfg)

        def loss_fn(params, batch):
            return model.loss_fn(params, {k: v[:max(v.shape[0] // 2, 1)]
                                          for k, v in batch.items()})
        return dataclasses.replace(model, loss_fn=loss_fn)

    monkeypatch.setattr(models, "build_model", halved)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "exchange_left_out"])
def test_broken_step_is_not_correct(fault, monkeypatch):
    from repro_torch.kernels import ops
    if fault == "state_unchanged":
        monkeypatch.setattr(ops, "gossip_mix", _no_mix)
    elif fault == "exchange_left_out":
        monkeypatch.setattr(ops, "gossip_mix", _no_exchange)
    else:
        _half_batch(monkeypatch)
    out = run(tiny("gpt2m-layup-param"))
    assert not out["correct"]


@pytest.mark.parametrize("cell", ["gpt2m-layup-param", "mamba2-layup-param"])
def test_low_precision_control_fails(cell):
    spec = tiny(cell)
    nums = readings(spec, SEED, ["control"], "cpu")["control"]["numbers"]
    assert not check.judge(nums, spec["limits"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ulp_distance(dtype):
    from h100bench.control import ulp_distance
    one = torch.tensor([1.0, -1.0, 0.0, -0.0, 2.0], dtype=dtype)
    up = torch.nextafter(one, torch.full_like(one, 4.0))
    assert ulp_distance(one, up).tolist() == [1, 1, 1, 1, 1]
    # across zero: the smallest subnormals on both sides are 2 apart
    tiny = torch.nextafter(torch.zeros(1, dtype=dtype),
                           torch.ones(1, dtype=dtype))
    assert ulp_distance(tiny, -tiny).tolist() == [2]
    assert ulp_distance(one, one).tolist() == [0] * 5


def test_ulp_look_of_the_program():
    spec = tiny("mamba2-layup-param")
    look = readings(spec, SEED, ["program"], "cpu", ulps=True)[
        "program"]["ulps"]
    assert look["all"]["vs_ref_0_1_max"][0] > 0.5
    for leaf, r in look.items():
        for key in ("moved_0_1_more", "ref_moved_0_1_more"):
            if key in r:
                assert sum(r[key]) == pytest.approx(1.0) and min(r[key]) >= 0


def test_seeded_inputs_repeat():
    from h100bench import inputs
    spec = tiny("mamba2-layup-param")
    shapes = {"a/w": (3, 4), "a/A_log": (5,), "b/norm": (2,)}
    rules = spec["config"]["init"]
    one = inputs.make_weights(shapes, torch.bfloat16, rules, SEED, "cpu")
    two = inputs.make_weights(shapes, torch.bfloat16, rules, SEED, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert torch.equal(one["b/norm"], torch.ones(2, dtype=torch.bfloat16))
    a = -torch.exp(one["a/A_log"].float())
    assert bool(((a <= -1) & (a >= -16.2)).all())
    b1 = inputs.make_batches(spec["traffic"], 128, SEED, "cpu")
    b2 = inputs.make_batches(spec["traffic"], 128, SEED, "cpu")
    assert all(torch.equal(x["tokens"], y["tokens"]) for x, y in zip(b1, b2))
    assert torch.equal(b1[0]["labels"][..., :-1], b1[0]["tokens"][..., 1:])
