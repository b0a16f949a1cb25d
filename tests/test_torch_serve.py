"""The port's serving loop (``repro_torch.launch.serve``): the seven cases of
``tests/test_serve.py`` on the port's models, and the loop's greedy outputs
against the JAX package's ``ServeLoop`` on the same (converted) weights.

Tolerances: token ids are compared exactly (greedy argmax over float32
logits that agree with the reference's to rtol 1e-4,
``tests/test_torch_decode.py``; the schedules below have no near-ties).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JServeLoop  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from _torch_parity import torch_cfg  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.pytree import tree_map  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def _model(arch="granite-8b", seed=0):
    """The port's reduced model with the JAX package's init, and the JAX
    model and params it came from."""
    jcfg = reduced(jax_get_config(arch))
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return (build_model(torch_cfg(jcfg)),
            to_torch(jax.tree.map(np.asarray, jp), "cpu"), jm, jp)


def _loop(m, params, **kw):
    return ServeLoop(m, params, device="cpu", **kw)


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_serve_completes_all_requests(arch):
    m, params, _, _ = _model(arch)
    cfg = m.cfg
    loop = _loop(m, params, num_slots=2, max_len=32)
    reqs = [Request(uid=i,
                    prompt=np.arange(3 + i, dtype=np.int32) % cfg.vocab_size,
                    max_new_tokens=4)
            for i in range(5)]  # 5 requests > 2 slots → queuing + reuse
    out = loop.serve(reqs)
    assert set(out) == {0, 1, 2, 3, 4}
    for uid, toks in out.items():
        assert len(toks) == 4
        assert all(0 <= t < cfg.vocab_size for t in toks)
    # continuous batching actually batched: fewer steps than sequential sum
    sequential = sum(len(r.prompt) + r.max_new_tokens for r in reqs)
    assert loop.steps_run < sequential


def test_serve_matches_teacher_forced_argmax():
    """The loop's greedy outputs == argmax of the full forward pass."""
    m, params, _, _ = _model()
    cfg = m.cfg
    prompt = np.asarray([5, 17, 3], np.int32)
    loop = _loop(m, params, num_slots=1, max_len=16)
    out = loop.serve([Request(uid=0, prompt=prompt, max_new_tokens=3)])[0]

    toks = list(prompt)
    with torch.no_grad():
        for _ in range(3):
            t = torch.tensor([toks])
            h = L.embed_apply(params["embed"], t)
            pos = torch.arange(len(toks))[None]
            h, _, _ = T.decoder_forward(params, h, cfg, positions=pos)
            h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
            logits = L.unembed_apply(params["embed"], h, cfg.tie_embeddings)
            toks.append(int(torch.argmax(logits[0, -1])))
    assert out == toks[len(prompt):], (out, toks[len(prompt):])


def test_eos_frees_slot_early():
    m, params, _, _ = _model()
    loop = _loop(m, params, num_slots=1, max_len=64)
    r = Request(uid=0, prompt=np.asarray([1], np.int32), max_new_tokens=50)
    loop.serve([r], max_steps=2)
    assert r.output
    eos = r.output[0]
    loop2 = _loop(m, params, num_slots=1, max_len=64)
    r2 = Request(uid=0, prompt=np.asarray([1], np.int32),
                 max_new_tokens=50, eos_id=eos)
    out = loop2.serve([r2])
    assert len(out[0]) == 1  # stopped at EOS immediately


def test_max_tokens_frees_slot_and_queued_request_fills_it():
    """A slot freed by max-tokens is reused by the next queued request on
    the immediately following step — no idle decode step in between."""
    m, params, _, _ = _model()
    loop = _loop(m, params, num_slots=1, max_len=32)
    r1 = Request(uid=0, prompt=np.asarray([1, 2], np.int32), max_new_tokens=2)
    r2 = Request(uid=1, prompt=np.asarray([3], np.int32), max_new_tokens=2)
    loop.submit(r1)
    loop.submit(r2)
    for _ in range(3):
        assert loop.step_once()
    assert r1.done and len(r1.output) == 2
    assert loop.slots[0].req is None          # slot freed the step it finished
    assert loop.step_once()                   # very next step decodes r2
    assert loop.slots[0].req is r2            # admitted into the freed slot
    loop.run()
    assert r2.done and len(r2.output) == 2
    assert loop.steps_run == 5                # 3 (r1) + 2 (r2), zero idle steps


def test_eos_frees_slot_and_queued_request_fills_it():
    """Same same-step handoff when the slot frees via EOS instead of the
    max-tokens bound."""
    m, params, _, _ = _model()
    probe = _loop(m, params, num_slots=1, max_len=32)
    rp = Request(uid=0, prompt=np.asarray([1], np.int32), max_new_tokens=1)
    probe.serve([rp])
    eos = rp.output[0]

    loop = _loop(m, params, num_slots=1, max_len=32)
    r1 = Request(uid=0, prompt=np.asarray([1], np.int32),
                 max_new_tokens=50, eos_id=eos)
    r2 = Request(uid=1, prompt=np.asarray([2], np.int32), max_new_tokens=1)
    loop.submit(r1)
    loop.submit(r2)
    assert loop.step_once()                   # r1 hits EOS on its first token
    assert r1.done and len(r1.output) == 1
    assert loop.slots[0].req is None
    assert loop.step_once()                   # next step serves r2, no idle gap
    assert r2.done and len(r2.output) == 1    # admitted AND served that step
    assert loop.steps_run == 2


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_prefill_by_decode_matches_one_shot_prefill(arch):
    """Feeding the prompt token-by-token through the decode step yields
    the same next token, and the same cache, as the one-shot prefill."""
    m, params, _, _ = _model(arch)
    prompt = np.asarray([5, 17, 3, 8], np.int32)

    loop = _loop(m, params, num_slots=1, max_len=16)
    out = loop.serve([Request(uid=0, prompt=prompt, max_new_tokens=1)])[0]

    cache, logits = m.prefill_fn(params, {"tokens": torch.from_numpy(prompt[None])})
    assert out[0] == int(torch.argmax(logits[0, -1]))
    if arch == "granite-8b":
        n = len(prompt)
        for key in ("k", "v"):
            torch.testing.assert_close(loop.cache["sub0"][key][:, :, :n],
                                       cache["sub0"][key], rtol=1e-4,
                                       atol=1e-5)


def test_serve_stats_accounting():
    m, params, _, _ = _model()
    loop = _loop(m, params, num_slots=2, max_len=32)
    assert loop.stats()["slot_occupancy"] == 0.0  # no steps yet
    reqs = [Request(uid=i, prompt=np.asarray([i + 1], np.int32),
                    max_new_tokens=3) for i in range(3)]
    loop.serve(reqs)
    s = loop.stats()
    assert s["requests_completed"] == 3
    assert s["tokens_emitted"] == sum(len(r.output) for r in reqs) == 9
    assert s["queue_depth"] == 0 and s["slots_busy"] == 0
    assert s["steps_run"] == loop.steps_run > 0
    assert 0.0 < s["slot_occupancy"] <= 1.0
    assert s["slot_occupancy"] == 9 / (s["steps_run"] * 2)
    assert s["params_version"] is None        # static params, never swapped


# ---------------------------------------------------------------------------
# against the JAX ServeLoop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_serve_loop_matches_jax_serve_loop(arch):
    """Five requests over two slots (queueing, slot reuse, a cache reset
    between sequences): the same tokens as the reference's loop, step for
    step, with the same accounting."""
    m, params, jm, jp = _model(arch, seed=3)
    prompts = [np.asarray(p, np.int32) for p in
               ([5, 17, 3], [9], [2, 4, 6, 8, 10], [11, 12], [7, 1, 7])]
    new = [4, 3, 2, 5, 3]
    tl = _loop(m, params, num_slots=2, max_len=16)
    jl = JServeLoop(jm, jp, num_slots=2, max_len=16)
    got = tl.serve([Request(uid=i, prompt=p, max_new_tokens=n)
                    for i, (p, n) in enumerate(zip(prompts, new))])
    want = jl.serve([JRequest(uid=i, prompt=p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, new))])
    assert got == want
    assert tl.stats() == jl.stats()


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def test_serve_loop_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    m, params, _, _ = _model()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(m, params, num_slots=1, max_len=8)


def test_serve_loop_refuses_params_on_another_device():
    m, params, _, _ = _model()
    meta = tree_map(lambda x: x, params)
    meta["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="meta"):
        ServeLoop(m, meta, num_slots=1, max_len=8, device="cpu")
    loop = _loop(m, params, num_slots=1, max_len=8)
    with pytest.raises(ValueError, match="meta"):
        loop.set_params(meta)
    assert loop.params is params
