"""Per-block activation checkpointing (``transformer.remat_block``, the port
of the reference's ``remat_block``).

(a) One block of each kind through the port's ``remat_block`` against the
    reference's ``remat_block``-wrapped block on the same weights (one JAX
    init carried across with ``repro_torch.convert``) and numpy inputs:
    a decoder super-block through each package's ``decoder_forward`` with
    one super-block (dense attention + MLP, SSM, MoE, the hybrid period),
    and the encoder-decoder's decoder block with ``enc_h`` as the
    differentiable const. The output and the gradients of h, the block's
    parameters and ``enc_h`` of ``sum(out · ct) + 0.7 · aux``. Tolerances:
    float32 outputs rtol 1e-5 with an atol of 1e-5 of the largest |value|,
    gradients rtol 1e-4 with an atol of 1e-4 of each leaf's largest
    gradient (``test_torch_model.py``'s decoder tolerance); bfloat16 2e-2
    of the largest |value| (a few bf16 roundings of float32 sums), and
    every gradient in its input's dtype, in both packages.
(b) Inside the port, remat against the run with ``remat_block`` replaced by
    the identity (the unwrapped path): bit for bit, for every family, on
    the loss and gradients of ``loss_fn``, on the prod step (monolithic,
    ``overlap=True``, ``streams=2``) and on ``make_step``'s lockstep route
    with ``accum_steps=2``.
(c) The memory effect: an outermost ``saved_tensors_hooks`` pack hook sums
    the distinct non-parameter storages the backward slice's graph holds.
    Non-reentrant checkpointing saves each block's input through that hook
    (and holds its parameter and const trees by reference), so with remat
    the sum falls to the block inputs plus the loss head, under a bound
    from the test's shapes; unwrapped it keeps every activation.
(d) ``remat_block`` adds nothing under ``no_grad``: ``f`` is called as is.
"""
import functools
from functools import partial
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (assert_runs_equal, model_pair,  # noqa: E402
                           np_tree, repeat_without_sharding, torch_cfg)
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.pytree import (tree_flatten, tree_leaves,  # noqa: E402
                                     tree_map, tree_unflatten)
from repro_torch.data.synthetic import lm_batch_for  # noqa: E402
from repro_torch.launch.mesh import WorkerMesh  # noqa: E402
from repro_torch.launch.train import make_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

FAMILIES = ["gpt2-medium", "mamba2-780m", "qwen3-moe-30b-a3b",
            "jamba-v0.1-52b", "qwen2-vl-2b", "whisper-large-v3"]
B, S, AUX_WEIGHT = 2, 16, 0.7


def unwrapped():
    """``remat_block`` replaced by the identity for the length of a
    ``with``: every block keeps its activations."""
    return mock.patch.object(T, "remat_block", lambda f: f)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what, grad=False):
    got, want = _f32(got), _f32(want)
    top = float(np.abs(want).max())
    if dtype == "bfloat16":
        tol = dict(rtol=2e-2, atol=2e-2 * top)
    elif grad:
        tol = dict(rtol=1e-4, atol=1e-4 * top)
    else:
        tol = dict(rtol=1e-5, atol=1e-5 * top)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


# ---------------------------------------------------------------------------
# (a) one block against the reference's remat_block
# ---------------------------------------------------------------------------

BLOCKS = [("gpt2-medium", "float32"), ("mamba2-780m", "float32"),
          ("qwen3-moe-30b-a3b", "float32"), ("jamba-v0.1-52b", "float32"),
          ("whisper-large-v3", "float32"), ("gpt2-medium", "bfloat16"),
          ("whisper-large-v3", "bfloat16")]
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _f32_pair(name, num_layers):
    return model_pair(name, num_layers=num_layers)


def _pair(name, num_layers, dtype):
    """``model_pair`` of ``reduced(name)`` at ``num_layers``; the bfloat16
    pair is the float32 one's weights rounded to bfloat16 (one JAX init a
    config for the module)."""
    jm, jp, tm, tp = _f32_pair(name, num_layers)
    if dtype == "float32":
        return jm, jp, tm, tp
    jcfg = jm.cfg.with_(dtype=jnp.bfloat16)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    return (jax_build_model(jcfg), jp, build_model(torch_cfg(jcfg)),
            to_torch(np_tree(jp), "cpu"))


def _inputs(d, dtype, seed, n=2, seq=S):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, seq, d)).astype(np.float32)
          for _ in range(n)]
    return ([jnp.asarray(x).astype(_JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(_TDT[dtype]) for x in xs])


def _port_grads(fn, h, tree):
    """``fn(h, tree) -> (out, aux)``'s output and the gradients of the
    objective's ``(h, tree)`` (``ct`` bound in ``fn``)."""
    h = h.clone().requires_grad_(True)
    leaves, treedef = tree_flatten(tree)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    obj, out = fn(h, tree_unflatten(treedef, leaves))
    grads = torch.autograd.grad(obj, [h] + leaves)
    return out, grads[0], tree_unflatten(treedef, list(grads[1:]))


def _objective_port(out, aux, ct):
    obj = (out.float() * ct.float()).sum()
    return obj if aux is None else obj + AUX_WEIGHT * aux


def _objective_jax(out, aux, ct):
    return jnp.sum(out.astype(jnp.float32) * ct.astype(jnp.float32)) \
        + AUX_WEIGHT * aux


def _check_block(name, dtype, out, dh, dp, jout, jdh, jdp, h, p):
    _close(out, jout, dtype, f"{name} output")
    _close(dh, jdh, dtype, f"{name} dh", grad=True)
    assert dh.dtype == h.dtype and jdh.dtype == _JDT[dtype]
    jflat = jax.tree_util.tree_flatten_with_path(jdp)[0]
    tleaves = tree_leaves(dp)
    assert len(jflat) == len(tleaves)
    for (path, jg), tg, tp in zip(jflat, tleaves, tree_leaves(p)):
        what = f"{name} d{jax.tree_util.keystr(path)}"
        _close(tg, jg, dtype, what, grad=True)
        assert tg.dtype == tp.dtype and jg.dtype == _JDT[dtype], what


@pytest.mark.parametrize("name,dtype", BLOCKS,
                         ids=[f"{n}-{d}" for n, d in BLOCKS])
def test_block_matches_reference_remat_block(monkeypatch, name, dtype):
    """One block through both packages' ``remat_block``: the output and
    the gradients of h, the block's parameters (and ``enc_h``), each
    gradient in its input's dtype."""
    monkeypatch.setattr(jnp, "repeat", repeat_without_sharding)
    if get_config(name).enc_dec:
        return _check_decoder_block(dtype)
    period = T._superblock_period(reduced(get_config(name)))
    jm, jp, tm, tp = _pair(name, period, dtype)
    jcfg, cfg = jm.cfg, tm.cfg
    assert tree_leaves(tp["blocks"])[0].shape[0] == 1  # one super-block
    (jh, jct), (th, tct) = _inputs(cfg.d_model, dtype, seed=7)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))

    def jfn(h, blocks):
        out, aux, _ = JT.decoder_forward({"blocks": blocks}, h, jcfg,
                                         positions=jnp.asarray(pos))
        return _objective_jax(out, aux, jct), out

    (_, jout), (jdh, jdp) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jh, jp["blocks"])

    def tfn(h, blocks):
        out, aux, _ = T.decoder_forward({"blocks": blocks}, h, cfg,
                                        positions=torch.from_numpy(pos))
        return _objective_port(out, aux, tct), out

    out, dh, dp = _port_grads(tfn, th, tp["blocks"])
    _check_block(name, dtype, out, dh, dp, jout, jdh, jdp, th, tp["blocks"])


def _check_decoder_block(dtype):
    """The encoder-decoder's decoder block: the reference's (as its
    ``decode_train`` composes it) through ``repro``'s ``remat_block``, the
    port's ``encdec.decoder_block`` through the port's, ``enc_h`` the
    differentiable const of both."""
    name = "whisper-large-v3"
    jm, jp, tm, tp = _pair(name, 1, dtype)
    jcfg, cfg = jm.cfg, tm.cfg
    (jh, jct, jenc), (th, tct, tenc) = _inputs(cfg.d_model, dtype, seed=9,
                                               n=3)
    jenc, tenc = jenc[:, :cfg.enc_seq // 2], tenc[:, :cfg.enc_seq // 2]
    se = jenc.shape[1]
    ic = {"positions": jnp.broadcast_to(jnp.arange(S)[None], (B, S)),
          "enc_positions": jnp.broadcast_to(jnp.arange(se)[None], (B, se))}

    def jblock(h, bp, dc, ic):
        h, _ = JT.attn_sublayer(bp["attn"], h, jcfg, positions=ic["positions"],
                                causal=True, window=jcfg.sliding_window)
        xk = jnp.einsum("bsd,dhk->bshk", dc["enc_h"], bp["cross"]["wk"])
        xv = jnp.einsum("bsd,dhk->bshk", dc["enc_h"], bp["cross"]["wv"])
        h = JED._cross_attn(bp["cross"], h, (xk, xv), jcfg,
                            positions=ic["positions"],
                            enc_positions=ic["enc_positions"], block_k=1024)
        h, _ = JT.mlp_sublayer(bp["mlp"], h, jcfg, use_moe=False)
        return h, ()

    jwrapped = JT.remat_block(jblock)
    jbp = jax.tree.map(lambda x: x[0], jp["dec_blocks"])

    def jfn(h, tree):
        out, _ = jwrapped(h, tree[0], {"enc_h": tree[1]}, ic)
        return _objective_jax(out, 0.0, jct), out

    (_, jout), (jdh, (jdp, jdenc)) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jh, (jbp, jenc))

    block = T.remat_block(partial(ED.decoder_block, cfg))
    tic = {"positions": torch.arange(S)[None].expand(B, S)}
    tbp = tree_map(lambda x: x[0], tp["dec_blocks"])

    def tfn(h, tree):
        out = block(h, tree["bp"], {"enc_h": tree["enc_h"]}, tic)
        return _objective_port(out, None, tct), out

    out, dh, grads = _port_grads(tfn, th, {"bp": tbp, "enc_h": tenc})
    _check_block(name, dtype, out, dh, grads["bp"], jout, jdh, jdp, th, tbp)
    _close(grads["enc_h"], jdenc, dtype, "d enc_h", grad=True)
    assert grads["enc_h"].dtype == tenc.dtype and jdenc.dtype == _JDT[dtype]


# ---------------------------------------------------------------------------
# (b) bit identity with the unwrapped path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Many small CPU ops: one intra-op thread, as the other multi-step
    port tests take (the test workers share the machine); restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name):
    model = build_model(reduced(get_config(name)))
    return model, model.init(seed=0, device="cpu")


def _batches(cfg, M, steps, seed=0):
    """``steps`` batches of ``cfg``'s family, ``M`` workers stacked on a
    leading axis (the VLM's positions (M, 3, B, S))."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        rows = [lm_batch_for(cfg, 4, S, generator=gen, device="cpu")
                for _ in range(M)]
        out.append({k: torch.stack([r[k] for r in rows]) for k in rows[0]})
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_bit_identical_to_unwrapped(name):
    """``loss_fn``'s loss, ce, aux and every gradient, remat against the
    unwrapped path."""
    model, params = _model(name)
    batch = {k: v[0] for k, v in _batches(model.cfg, 1, 1)[0].items()}

    def run():
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, met = model.loss_fn(tree_unflatten(treedef, leaves), batch)
        return [loss, met["ce"], met["aux"]] + list(
            torch.autograd.grad(loss, leaves, allow_unused=True))

    got = run()
    with unwrapped():
        want = run()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None and w is None) or torch.equal(g, w), (name, i)


def _run(name, steps=3, **engine):
    """``(histories, planes)`` of the prod step on ``reduced(name)`` at
    M=2, R=2, D=1, as ``assert_runs_equal`` takes them."""
    from _torch_parity import STEP_METRICS, materialize

    model, params = _model(name)
    be = make_backend("prod", "layup", M=2, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=2, update_delay=1, use_pallas=True,
                      device="cpu", wait_timeout_s=20.0, **engine)
    try:
        st = be.init(None, params)
        hist = []
        for b in _batches(model.cfg, 2, steps, seed=3):
            st, m = be.step(st, b)
            hist.append({k: np.asarray(m[k]) for k in STEP_METRICS})
        read = {k: v.clone() for k, v in materialize(be, st["read"]).items()}
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    return hist, {"read": read}


ENGINES = {"monolithic": {}, "overlap": dict(overlap=True),
           "streams2": dict(overlap=True, streams=2)}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", FAMILIES)
def test_prod_step_bit_identical_to_unwrapped(name, engine):
    """The prod step's metrics and read plane, remat against the
    unwrapped path, on each engine (the stream engine's forward thread
    recomputes on its own plane and CUDA stream)."""
    got = _run(name, **ENGINES[engine])
    with unwrapped():
        want = _run(name, **ENGINES[engine])
    assert_runs_equal(got, want)
    assert all(np.isfinite(h["loss"]).all() for h in got[0])


@pytest.mark.parametrize("name", ["gpt2-medium", "qwen3-moe-30b-a3b"])
def test_make_step_accum_bit_identical_to_unwrapped(name):
    """``make_step``'s lockstep route with ``accum_steps=2``: losses and
    parameters, remat against the unwrapped path."""
    model, params = _model(name)
    M = 2
    batches = [{k: v.reshape((M * 4,) + tuple(v.shape[2:]))
                for k, v in b.items()} for b in _batches(model.cfg, M, 2)]

    def run():
        step = make_step(model, WorkerMesh(M, "cpu"),
                         ShapeConfig("t", S, M * 4, "train"),
                         optimizer=momentum(0.9), schedule=constant(0.05),
                         accum_steps=2, use_pallas=True)
        p, o, w = step.init_state(tree_map(
            lambda x: x[None].expand((M,) + tuple(x.shape)), params))
        losses = []
        for t, b in enumerate(batches):
            p, o, w, loss = step.fn(p, o, w, b, t, 0)
            losses.append(loss)
        return losses, tree_leaves(p)

    got = run()
    with unwrapped():
        want = run()
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


# ---------------------------------------------------------------------------
# (c) what the backward slice holds
# ---------------------------------------------------------------------------


def _saved_bytes(model, params, batch):
    """Bytes of the distinct storages, parameters' excepted, that the pack
    hook sees while ``loss_fn`` records its graph."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    own = {p.untyped_storage().data_ptr() for p in leaves}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss_fn(tree_unflatten(treedef, leaves), batch)
    torch.autograd.grad(loss, leaves, allow_unused=True)
    return sum(seen.values())


@pytest.mark.parametrize("name", FAMILIES)
def test_backward_slice_keeps_block_inputs_and_head(name):
    """With remat the saved bytes fall to the block inputs plus the loss
    head: under ``(blocks + 4)·B·S·d`` activations of the hidden dtype
    (the blocks' inputs, the final norm's input, output and statistics)
    plus ``3·B·S·V`` float32 (logits, their softmax, the loss) and 1 KiB
    (B the batch's rows);
    the encoder's blocks add theirs at its length. Unwrapped, every layer
    keeps at least four more hidden-sized activations."""
    cfg = reduced(get_config(name)).with_(num_layers=4, enc_layers=4)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = {k: v[0] for k, v in _batches(cfg, 1, 1)[0].items()}
    remat = _saved_bytes(model, params, batch)
    with unwrapped():
        plain = _saved_bytes(model, params, batch)
    rows = batch["labels"].shape[0]
    h = rows * S * cfg.d_model * cfg.dtype.itemsize
    blocks = cfg.num_layers // T._superblock_period(cfg)
    bound = (blocks + 4) * h + 3 * rows * S * cfg.vocab_size * 4 + 1024
    if cfg.enc_dec:
        bound += cfg.enc_layers * rows * cfg.enc_seq * cfg.d_model \
            * cfg.dtype.itemsize
    assert remat <= bound, (remat, bound)
    assert plain >= remat + 4 * cfg.num_layers * h, (plain, remat)


# ---------------------------------------------------------------------------
# (d) nothing under no_grad
# ---------------------------------------------------------------------------


def test_no_grad_calls_the_block_as_is():
    """Outside a recorded graph ``remat_block(f)`` returns ``f``'s own
    result and saves nothing; inside one, the block's internals are not
    saved by the caller's hooks."""
    calls = []

    def f(h, p, dc, ic):
        calls.append(torch.is_grad_enabled())
        return torch.tanh(h * p["w"]) + dc["c"] * ic["k"]

    h = torch.randn(3, 4)
    p = {"w": torch.randn(4, requires_grad=True)}
    dc, ic = {"c": torch.randn(4)}, {"k": torch.tensor(2)}
    seen = []
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: seen.append(t) or t, lambda t: t):
        out = T.remat_block(f)(h, p, dc, ic)
    assert calls == [False] and seen == [] and out.grad_fn is None
    assert torch.equal(out, torch.tanh(h * p["w"]) + dc["c"] * 2)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: seen.append(t) or t, lambda t: t):
        out = T.remat_block(f)(h, p, dc, ic)
    # the block's input is all the caller's hook sees
    assert len(seen) == 1 and seen[0] is h
    out.sum().backward()
    assert calls == [False, True, True]  # the forward, then its recompute
