"""The port's sim trainer and its nine registered algorithms against the
JAX package's, step by step on the same numpy inputs and the same random
draws (the reference's peers and matchings injected into the port's draw
functions).

* Every algorithm on the MLP fixture at M=4, (R, D) = (1, 0), and at
  (2, 1) for the asynchronous family; ``adpsgd`` also at M=3 (the odd one
  out of the matching); LayUp with a straggler.
* Losses and metrics rtol 1e-5; planes, queued messages and SlowMo/CO2
  buffers rtol 1e-5 / atol 1e-6 (``_torch_parity.py``); push-sum weights
  rtol 1e-6; version clocks equal.
* Peer selection, push-sum and the matching: the port's functions on the
  JAX draws equal the JAX functions; their invariants under hypothesis on
  the port's own draws.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _fixtures import mlp_batch, mlp_problem  # noqa: E402
from _torch_parity import (jax_draws, pack_np, run_sim_pair,  # noqa: E402
                           torch_mlp_loss)
from repro.core import get_algorithm as jax_get_algorithm  # noqa: E402
from repro.core.adpsgd import random_matching as jax_matching  # noqa: E402
from repro.core.api import choose_peers as jax_choose  # noqa: E402
from repro.core.api import pushsum_weight_update as jax_pushsum  # noqa: E402
from repro.core.layerview import LayerPartition as JaxPartition  # noqa: E402
from repro_torch.core import adpsgd, api  # noqa: E402
from repro_torch.core.api import (choose_peers, consensus,  # noqa: E402
                                  get_algorithm, list_algorithms,
                                  pushsum_weight_update)
from repro_torch.core.layerview import LayerPartition  # noqa: E402

ASYNC = ["layup", "layup-block", "layup-hypercube", "gosgd", "adpsgd", "co2"]
SYNC = ["ddp", "localsgd", "slowmo"]
# the periodic algorithms sync every 2 steps, so 5 steps sync twice
ALGO_KW = {"localsgd": {"sync_every": 2}, "slowmo": {"sync_every": 2},
           "co2": {"sync_every": 2}}


def _mlp_pair(monkeypatch, algo, M=4, R=1, D=0, **kw):
    jloss, jparams = mlp_problem()
    return run_sim_pair(monkeypatch, algo, M, R, D, jloss=jloss,
                        tloss=torch_mlp_loss, params=jparams,
                        batch_fn=lambda t: mlp_batch(t, M=M, b=4 * R),
                        algo_kw=ALGO_KW.get(algo), **kw)


def test_registry_matches_jax():
    from repro.core import list_algorithms as jax_list

    assert list_algorithms() == jax_list()
    for name in list_algorithms():
        a, j = get_algorithm(name), jax_get_algorithm(name)
        assert (a.name, a.asynchronous) == (j.name, j.asynchronous)
    with pytest.raises(KeyError, match="unknown algorithm"):
        get_algorithm("nope")


@pytest.mark.parametrize("algo", ASYNC + SYNC)
def test_algorithm_matches_jax(monkeypatch, algo):
    """(R, D) = (1, 0), M=4, 5 steps."""
    _mlp_pair(monkeypatch, algo)


@pytest.mark.parametrize("algo", ASYNC)
def test_decoupled_algorithm_matches_jax(monkeypatch, algo):
    """(R, D) = (2, 1): the forward lane's slices and the FIFO's ring."""
    _, _, hist = _mlp_pair(monkeypatch, algo, R=2, D=1)
    assert [float(m["update_staleness"]) for m in hist] == [0.0] + [1.0] * 4


def test_adpsgd_odd_one_out_matches_jax(monkeypatch):
    """M=3: one worker of the matching is left unmatched each step."""
    _, _, hist = _mlp_pair(monkeypatch, "adpsgd", M=3)
    assert all(float(m["pairs"]) == 1.0 for m in hist)


def test_straggler_mask_matches_jax(monkeypatch):
    """Worker 0 updates and gossips every third step only."""
    _mlp_pair(monkeypatch, "layup", straggler_delays=[2, 0, 0, 0])


# ---------------------------------------------------------------------------
# peer selection, push-sum, the matching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,seed", [(4, 1), (8, 2), (13, 4)])
def test_choose_peers_matches_jax_on_its_draws(monkeypatch, M, seed):
    cur = {}
    monkeypatch.setattr(api, "draw_peers",
                        lambda rng, M, device: cur["peers"])
    key = jax.random.PRNGKey(seed)
    active = np.array(jax.random.bernoulli(jax.random.fold_in(key, 9), 0.7,
                                           (M,)))
    jax_draws(cur, key, M)
    r1 = jax.random.split(key)[0]
    want = jax_choose(r1, M, jnp.asarray(active))
    got = choose_peers(None, M, torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w = np.random.default_rng(seed).uniform(0.1, 1.0, M).astype(np.float32)
    np.testing.assert_allclose(
        pushsum_weight_update(torch.from_numpy(w), *got).numpy(),
        np.asarray(jax_pushsum(jnp.asarray(w), *want)), rtol=1e-7)


@pytest.mark.parametrize("M", [3, 6])
def test_random_matching_matches_jax_on_its_draws(monkeypatch, M):
    key = jax.random.PRNGKey(M)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, M)))
    monkeypatch.setattr(adpsgd, "draw_permutation",
                        lambda rng, M, device: perm)
    np.testing.assert_array_equal(adpsgd.random_matching(None, M).numpy(),
                                  np.asarray(jax_matching(key, M)))


@pytest.mark.parametrize("M", [1, 4, 6, 8])
def test_hypercube_peers_match_jax(M):
    for step in range(4):
        got = get_algorithm("layup-hypercube")._peers(
            None, M, torch.ones(M, dtype=torch.bool), step)
        want = jax_get_algorithm("layup-hypercube")._peers(
            jax.random.PRNGKey(0), M, jnp.ones(M, bool), step)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SETTINGS = dict(max_examples=20, deadline=None)


@given(m=st.integers(2, 24), seed=st.integers(0, 2**30),
       steps=st.integers(1, 8))
@settings(**SETTINGS)
def test_weight_sum_invariant(m, seed, steps):
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand((m,), generator=gen) + 0.05
    w = w / w.sum()
    active = torch.rand((m,), generator=gen) < 0.7
    for _ in range(steps):
        w = pushsum_weight_update(w, *choose_peers(gen, m, active))
    assert float(w.sum()) == pytest.approx(1.0, abs=1e-5)
    assert float(w.min()) > 0.0


@given(m=st.integers(2, 24), seed=st.integers(0, 2**30))
@settings(**SETTINGS)
def test_winner_targets_unique(m, seed):
    gen = torch.Generator().manual_seed(seed)
    send_ok, has_recv, sender_idx = choose_peers(
        gen, m, torch.ones(m, dtype=torch.bool))
    senders = sender_idx[has_recv].tolist()
    assert len(senders) == len(set(senders))
    assert int(send_ok.sum()) == int(has_recv.sum()) > 0
    assert not (sender_idx[has_recv] == torch.arange(m)[has_recv]).any()


@given(m=st.integers(2, 16), seed=st.integers(0, 2**30))
@settings(**SETTINGS)
def test_matching_is_involution(m, seed):
    p = adpsgd.random_matching(torch.Generator().manual_seed(seed), m)
    assert torch.equal(p[p], torch.arange(m))


@given(m=st.integers(2, 12), n=st.integers(1, 20), seed=st.integers(0, 2**30))
@settings(**SETTINGS)
def test_layup_mix_preserves_weighted_mean(m, n, seed):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((m, n), generator=gen)}
    w = torch.rand((m,), generator=gen) + 0.05
    w = w / w.sum()
    part = LayerPartition(params)
    before = consensus(params, w)["w"]  # post writes into params' buffers
    v2, w2, _, _ = get_algorithm("layup").post(
        part.view(params, M=m), w, (), part.split({"w": torch.zeros(m, n)}),
        torch.ones(m, dtype=torch.bool), gen, 0)
    np.testing.assert_allclose(consensus(part.join(v2.groups), w2)["w"],
                               before, rtol=1e-4, atol=1e-5)


def test_hooks_on_a_layer_partition_match_jax(monkeypatch):
    """The hooks on ``LayerPartition.split`` groups (nested, not the flat
    plane), as the JAX package's tests call them: Σw conserved for every
    gossip mode over 5 steps, and the groups equal the JAX hooks'."""
    cur = {}
    monkeypatch.setattr(api, "draw_peers",
                        lambda rng, M, device: cur["peers"])
    monkeypatch.setattr(adpsgd, "draw_permutation",
                        lambda rng, M, device: cur["perm"])
    M = 8
    rng = np.random.default_rng(0)
    params = {"l1": rng.standard_normal((M, 4, 3)).astype(np.float32),
              "l2": rng.standard_normal((M, 3)).astype(np.float32)}
    w0 = rng.uniform(0.1, 1.0, M).astype(np.float32)
    w0 /= w0.sum()
    for name in ("layup", "layup-hypercube", "adpsgd", "layup-block"):
        jalgo, talgo = jax_get_algorithm(name), get_algorithm(name)
        jpart = JaxPartition(params)
        # the port's hooks write into the groups' buffers: its own copy
        tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        tpart = LayerPartition(tparams)
        jview, tview = jpart.view(params, M=M), tpart.view(tparams, M=M)
        jw, tw = jnp.asarray(w0), torch.from_numpy(w0)
        jx, tx = jalgo.init_extras(jview, M), talgo.init_extras(tview, M)
        upd = {k: 0.01 * np.ones_like(v) for k, v in params.items()}
        for step in range(5):
            key = jax.random.PRNGKey(10 + step)
            jax_draws(cur, jax.random.fold_in(key, 0), M)
            r1 = jax.random.split(jax.random.fold_in(key, 0))[0]
            jview, jw, jx = jalgo.pre(jview, jw, jx, jnp.int32(step))
            tview, tw, tx = talgo.pre(tview, tw, tx, step)
            jview, jw, jx, _ = jalgo.post(
                jview, jw, jx, jpart.split(upd), jnp.ones(M, bool), r1,
                jnp.int32(step))
            tview, tw, tx, _ = talgo.post(
                tview, tw, tx, tpart.split(
                    {k: torch.from_numpy(v) for k, v in upd.items()}),
                torch.ones(M, dtype=torch.bool), None, step)
        in_flight = (float(tx["q0"]["w"].sum() + tx["q1"]["w"].sum())
                     if isinstance(tx, dict) else 0.0)
        assert float(tw.sum()) + in_flight == pytest.approx(1.0, abs=1e-5)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_array_equal(tview.versions.numpy(),
                                      np.asarray(jview.versions))
        got = tpart.join(tview.groups)
        want = jpart.join(jview.groups)
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        assert tpart.group_index("l2") == jpart.group_index("l2") == 1


def test_pack_np_round_trip():
    """The helper the parity tests compare planes with."""
    _, jparams = mlp_problem()
    from repro_torch.core.layerview import FlatPartition

    part = FlatPartition({k: torch.from_numpy(np.array(v))
                          for k, v in jparams.items()})
    plane = pack_np(part, jparams)
    back = part.unpack(plane)
    for k in jparams:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jparams[k]))


@pytest.mark.parametrize("chunk", [1, 3, 1 << 24])
def test_hooks_in_chunks_equal_one_pass(monkeypatch, chunk):
    """``columns_`` computes the hooks a chunk of columns at a time: the
    result is the same bits whatever the chunk (every algorithm's step)."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    monkeypatch.setattr(api, "_HOOK_CHUNK", chunk)
    _, jparams = mlp_problem()
    out = {}
    for name in list_algorithms():
        be = make_backend("sim", get_algorithm(name, **ALGO_KW.get(name, {})),
                          M=4, loss_fn=torch_mlp_loss, optimizer=momentum(0.9),
                          schedule=constant(0.05), device="cpu")
        st = be.init(0, {k: np.array(v) for k, v in jparams.items()})
        for t in range(3):
            st, _ = be.step(st, {k: np.array(v) for k, v in
                                 mlp_batch(t, M=4, b=4).items()})
        out[name] = st.params
    if chunk != 1 << 24:
        monkeypatch.setattr(api, "_HOOK_CHUNK", 1 << 24)
        for name, plane in out.items():
            be = make_backend(
                "sim", get_algorithm(name, **ALGO_KW.get(name, {})), M=4,
                loss_fn=torch_mlp_loss, optimizer=momentum(0.9),
                schedule=constant(0.05), device="cpu")
            st = be.init(0, {k: np.array(v) for k, v in jparams.items()})
            for t in range(3):
                st, _ = be.step(st, {k: np.array(v) for k, v in
                                     mlp_batch(t, M=4, b=4).items()})
            for k in plane:
                assert torch.equal(plane[k], st.params[k]), (name, k)


def test_step_consumes_its_state():
    """The old state's fields are released by the step (the buffers it
    held are the new state's or freed)."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    be = make_backend("sim", "layup", M=4, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      update_delay=1, device="cpu")
    _, jparams = mlp_problem()
    st = be.init(0, {k: np.array(v) for k, v in jparams.items()})
    buf = st.params["l1"]
    new, _ = be.step(st, {k: np.array(v) for k, v in
                          mlp_batch(0, M=4, b=4).items()})
    assert st.params is None and st.opt_state is None and st.delay is None
    assert new.params["l1"] is buf  # written in place
