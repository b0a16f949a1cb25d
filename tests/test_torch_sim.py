"""The port's sim backend, its TrainerBackend protocol and the drift
diagnostics, against the JAX package's.

* The protocol over the three kinds (``make_backend("sim" | "event" |
  "prod")``), lock-step driving, ``drive``'s history, the guards.
* Within the port, the sim ``layup-hypercube`` equals the prod ``layup``
  at M=1 for (R, D) ∈ {(1,0), (1,1), (2,1)}: staleness equal, loss within
  1e-5 (the reference's ``test_sim_prod_parity``).
* ``layup`` and ``ddp`` on a cut GPT-2 decoder (2 layers, d 64) against
  the JAX sim trainer: loss and metrics rtol 1e-5, planes rtol 1e-4 /
  atol 1e-6 (``_torch_parity.py``).
* ``gradient_bias``, ``estimate_lipschitz`` (the JAX noise injected),
  ``elastic_constant`` and ``lemma61_bound`` against the JAX functions.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _fixtures import mlp_batch, mlp_problem  # noqa: E402
from _torch_parity import (mlp_params, np_tree, run_sim_pair,  # noqa: E402
                           torch_cfg, torch_mlp_loss)
from repro.core import drift as jdrift  # noqa: E402
from repro_torch.core import drift  # noqa: E402
from repro_torch.core.api import TrainState, get_algorithm  # noqa: E402
from repro_torch.core.backend import (TrainerBackend, drive,  # noqa: E402
                                      make_backend)
from repro_torch.core.simulator import HardwareModel  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

M = 4
HW = HardwareModel(fwd_time=1.0, bwd_ratio=2.0, num_layers=24,
                   model_bytes=1.6e9, bandwidth=25e9,
                   allreduce_bandwidth=100e9)


def _sim(algo="layup", **kw):
    return make_backend("sim", algo, M=kw.pop("M", M), loss_fn=torch_mlp_loss,
                        optimizer=momentum(0.9), schedule=constant(0.05),
                        device="cpu", **kw)


def _batches(n, M=M, b=8):
    return [np_tree(mlp_batch(t, M=M, b=b)) for t in range(n)]


class TestProtocol:
    def test_every_kind_satisfies_protocol(self):
        sim = _sim()
        ev = make_backend("event", "layup", M=M, hw=HW)
        prod = make_backend("prod", "layup", M=M, loss_fn=torch_mlp_loss,
                            optimizer=momentum(0.9), schedule=constant(0.05),
                            device="cpu")
        for be, kind in ((sim, "sim"), (ev, "event"), (prod, "prod")):
            assert isinstance(be, TrainerBackend) and be.kind == kind

    def test_lockstep_drive(self):
        sim = _sim()
        ev = make_backend("event", "layup", M=M, hw=HW)
        st = sim.init(0, mlp_params())
        es = ev.init()
        for b in _batches(5):
            st, m_num = sim.step(st, b)
            es, m_ev = ev.step(es, None, None)
        assert isinstance(st, TrainState) and st.step == 5
        assert np.isfinite(float(m_num["loss"]))
        assert m_ev["iter_time"] > 0
        assert sim.summary()["steps"] == ev.summary()["steps"] == 5.0
        assert ev.summary()["total_time"] == pytest.approx(
            ev.result().total_time)

    def test_drive_collects_history_and_draws_from_one_generator(self):
        """Two drives from the same seed give the same bits; the sim
        backend's steps draw from the generator its init made."""
        outs = [drive(_sim(), _batches(4), 7, mlp_params(),
                      history_keys=("loss", "layer_staleness",
                                    "gossip_sends"))
                for _ in range(2)]
        assert outs[0]["history"]["loss"].shape == (4,)
        assert outs[0]["history"]["layer_staleness"].shape == (4, 2)
        assert outs[0]["steps"] == 4.0
        for k in ("loss", "layer_staleness", "gossip_sends"):
            np.testing.assert_array_equal(outs[0]["history"][k],
                                          outs[1]["history"][k])
        other = drive(_sim(), _batches(4), 8, mlp_params(),
                      history_keys=("loss",))
        assert not np.array_equal(other["history"]["loss"],
                                  outs[0]["history"]["loss"])

    def test_export_params_unpacks_the_plane(self):
        be = _sim()
        st = be.init(0, mlp_params())
        tree = be.export_params(st)
        assert tree["l1"].shape == (M, 16, 32)
        np.testing.assert_array_equal(tree["l1"][2].numpy(),
                                      mlp_params()["l1"])

    def test_event_alias_for_block_and_hypercube(self):
        for name, expect in (("layup-block", "gosgd"),
                             ("layup-hypercube", "layup")):
            assert make_backend("event", name, M=M,
                                hw=HW)._event_algo == expect

    def test_unknown_kind_and_missing_pieces_raise(self):
        with pytest.raises(ValueError, match="unknown backend kind"):
            make_backend("mesh", "layup", M=M)
        with pytest.raises(ValueError, match="sim backend needs"):
            make_backend("sim", "layup", M=M)
        with pytest.raises(ValueError, match="fb_ratio"):
            _sim(fb_ratio=0)

    def test_sim_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: device=None resolves "
                        "to it")
        with pytest.raises(RuntimeError, match="CUDA"):
            make_backend("sim", "ddp", M=M, loss_fn=torch_mlp_loss,
                         optimizer=momentum(0.9), schedule=constant(0.05))

    def test_every_algorithm_runs_decoupled(self):
        """The reference's acceptance: every algorithm at R=2, D=1 behind
        the protocol, per-layer staleness exposed, the applied gradient
        exactly one step old after the warm-up."""
        for name in ("ddp", "layup", "gosgd", "adpsgd", "localsgd",
                     "slowmo", "co2", "layup-block", "layup-hypercube"):
            out = drive(_sim(name, fb_ratio=2, update_delay=1), _batches(4),
                        0, mlp_params(),
                        history_keys=("layer_staleness", "loss",
                                      "update_staleness", "weight_sum"))
            h = out["history"]
            assert h["layer_staleness"].shape == (4, 2), name
            assert np.isfinite(h["loss"]).all(), name
            assert h["update_staleness"][-1] == 1.0, name


@pytest.mark.parametrize("R,D", [(1, 0), (1, 1), (2, 1)])
def test_sim_prod_parity(R, D):
    """The reference's acceptance, inside the port: the sim
    ``layup-hypercube`` and the prod ``layup`` at M=1 (one worker: nothing
    is sent), step by step."""
    kw = dict(M=1, loss_fn=torch_mlp_loss, optimizer=momentum(0.9),
              schedule=constant(0.05), fb_ratio=R, update_delay=D,
              device="cpu")
    prod = make_backend("prod", "layup", **kw)
    sim = make_backend("sim", "layup-hypercube", **kw)
    ps = prod.init(None, mlp_params())
    ss = sim.init(0, mlp_params())
    for b in _batches(5, M=1):
        ps, pm = prod.step(ps, b)
        ss, sm = sim.step(ss, b)
        assert abs(float(pm["loss"]) - float(sm["loss"])) < 1e-5
        np.testing.assert_array_equal(pm["layer_staleness"].numpy(),
                                      sm["layer_staleness"].numpy())
        assert float(pm["update_staleness"]) == float(sm["update_staleness"])
        assert float(pm["weight_sum"]) == pytest.approx(1.0)
    assert prod.summary()["steps"] == sim.summary()["steps"] == 5.0


# ---------------------------------------------------------------------------
# a cut GPT-2 decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder():
    from repro.configs import get_config
    from repro.data.synthetic import SyntheticLM
    from repro.models import build_model as jax_build_model
    from repro_torch.models import build_model

    jcfg = get_config("gpt2-medium").with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=128)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    ds = SyntheticLM(vocab=jcfg.vocab_size, seq_len=16, temperature=1.2,
                     seed=0)

    def batch(t):
        rng = np.random.default_rng(100 + t)
        bs = [ds.sample(rng, 4) for _ in range(M)]
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}

    return (lambda p, b: jmodel.loss_fn(p, b, block_k=8), jparams,
            build_model(torch_cfg(jcfg)).loss_fn, batch)


@pytest.mark.parametrize("algo", ["layup", "ddp"])
def test_decoder_matches_jax(monkeypatch, decoder, algo):
    jloss, jparams, tloss, batch = decoder
    _, _, hist = run_sim_pair(monkeypatch, algo, M, 2, 1, jloss=jloss,
                              tloss=tloss, params=jparams, batch_fn=batch,
                              rtol=1e-4)
    assert all(abs(float(m["loss"]) - np.log(128)) < 1.0 for m in hist)


# ---------------------------------------------------------------------------
# drift diagnostics (Lemma 6.1)
# ---------------------------------------------------------------------------


def _drift_inputs():
    jloss, jparams = mlp_problem()
    b = np_tree(mlp_batch(0, M=1, b=8))
    b0 = {k: v[0] for k, v in b.items()}
    p = np_tree(jparams)
    rng = np.random.default_rng(3)
    p_tilde = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in p.items()}
    return jloss, p, p_tilde, b0


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_gradient_bias_matches_jax():
    jloss, p, p_tilde, b0 = _drift_inputs()
    want = jdrift.gradient_bias(jloss, p, p_tilde, b0)
    got = drift.gradient_bias(torch_mlp_loss, _t(p), _t(p_tilde), _t(b0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_estimate_lipschitz_matches_jax_on_its_noise(monkeypatch):
    """The JAX probes' noise injected: the same K̂."""
    jloss, p, _, b0 = _drift_inputs()
    key = jax.random.PRNGKey(4)
    leaves = jax.tree.leaves(p)

    def jax_noise(rng, i, tleaves):
        r = jax.random.fold_in(key, i)
        return [torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(r, j), leaf.shape, jnp.float32)))
            for j, leaf in enumerate(leaves)]

    monkeypatch.setattr(drift, "probe_noise", jax_noise)
    want = jdrift.estimate_lipschitz(jloss, p, b0, key, n_probes=3)
    got = drift.estimate_lipschitz(torch_mlp_loss, _t(p), _t(b0), None,
                                   n_probes=3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_elastic_constant_and_bound_match_jax():
    rng = np.random.default_rng(5)
    stacked = {"w": rng.standard_normal((M, 6, 3)).astype(np.float32),
               "b": rng.standard_normal((M, 3)).astype(np.float32)}
    w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    want = jdrift.elastic_constant(stacked, jnp.asarray(w), 0.05)
    got = drift.elastic_constant(_t(stacked), torch.from_numpy(w), 0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(drift.lemma61_bound(got, 0.05, 2.0)),
                               float(jdrift.lemma61_bound(want, 0.05, 2.0)),
                               rtol=1e-5)


def test_lemma61_bias_bound_on_a_trained_state():
    """The reference's empirical check of Lemma 6.1 on the port's own
    trained state: ‖b‖² ≤ 4·K̂²·η²·B̂² (× 1.5 slack for estimation)."""
    be = _sim("layup", M=8)
    st = be.init(0, mlp_params())
    for b in _batches(30, M=8):
        st, _ = be.step(st, b)
    tree = be.export_params(st)
    p0 = {k: v[0] for k, v in tree.items()}
    p1 = {k: v[1] for k, v in tree.items()}
    w0, w1 = float(st.weights[0]), float(st.weights[1]) / 2
    a, c = w0 / (w0 + w1), w1 / (w0 + w1)
    p_tilde = {k: a * p0[k] + c * p1[k] for k in p0}
    b0 = {k: torch.from_numpy(np.array(v[0])) for k, v in
          _batches(1, M=8)[0].items()}
    gen = torch.Generator().manual_seed(0)
    k_hat = drift.estimate_lipschitz(torch_mlp_loss, p0, b0, gen,
                                     n_probes=8)
    b_hat = drift.elastic_constant(tree, st.weights, 0.05)
    bias = drift.gradient_bias(torch_mlp_loss, p0, p_tilde, b0)
    assert float(bias) ** 2 <= float(drift.lemma61_bound(k_hat, 0.05,
                                                         b_hat)) * 1.5


def test_algorithm_instance_and_name_build_the_same_backend():
    a = _sim(get_algorithm("gosgd"))
    b = _sim("gosgd")
    assert a.name == b.name == "sim:gosgd"


def test_new_modules_import_neither_jax_nor_the_reference():
    """The sibling of ``test_torch_chaos.py``'s import check for this
    slice's modules: with ``jax`` and ``repro`` blocked they import, and a
    sim step, an event step and a cutout timing go through."""
    import os
    import subprocess
    import sys

    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import torch
from repro_torch.checkpoint import save_checkpoint, restore_checkpoint
from repro_torch.core import (adpsgd, api, backend, co2, ddp, drift, gosgd,
                              layup, localsgd, simulator, slowmo)
from repro_torch.launch import analysis, tuner
from repro_torch.optim import constant, sgd
def loss(p, b):
    return ((b["x"] @ p["w"]) ** 2).mean(), {}
kw = dict(M=2, loss_fn=loss, optimizer=sgd(), schedule=constant(0.1),
          device="cpu")
be = backend.make_backend("sim", "layup", **kw)
st = be.init(0, {"w": np.ones((4, 2), np.float32)})
st, m = be.step(st, {"x": np.ones((2, 2, 4), np.float32)})
assert float(m["weight_sum"]) == 1.0
ev = backend.make_backend("event", "layup", M=2)
es, em = ev.step(ev.init(), None)
assert em["iter_time"] > 0
pr = backend.make_backend("prod", "layup", overlap=True, **kw)
ps = pr.init(None, {"w": np.ones((4, 2), np.float32)})
ps, _ = pr.step(ps, {"x": np.ones((2, 2, 4), np.float32)})
cut = tuner.extract_cutouts(pr.engine)["update"]
assert tuner.CutoutHarness(warmup=0, reps=1).time_cutout(cut)["reps"] == 1
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print("ok")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
