"""horovod_tpu_torch's DecodeEngine against horovod_tpu's, token for token.

The reference's test configuration (vocab 64, d_model 32, 4 heads, d_ff
64, 2 layers, seq 64, fp32, pages of 8 tokens); its parameters go
through ``convert.params_from_jax`` into the port.  The same seeded
``synthetic_workload`` schedules (and hand-built prompt sets) run through
both engines, and every request's tokens must be equal: continuous and
static batching, the prefix cache on and off, chunked prefill,
speculative greedy decoding, seeded sampling (draw for draw, with and
without a draft), a hot swap, export → adopt; with the counters the
reference's tests pin (shape-key counts, page accounting, prefix-cache
and speculative statistics) equal too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as tfm_j
from horovod_tpu.serving import engine as eng_j
from horovod_tpu.serving import loadgen as load_j
from horovod_tpu.serving import speculative as spec_j
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.serving import engine as eng_t
from horovod_tpu_torch.serving import loadgen as load_t
from horovod_tpu_torch.serving import speculative as spec_t

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=64, remat=False)
CFG_J = tfm_j.TransformerConfig(dtype=jnp.float32, **SMALL)
CFG = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
PAGE = 8
PROMPT = [5, 9, 13, 2, 7, 11, 3, 1, 6, 4, 12, 8, 10, 14, 15, 16, 17]


def _port(tree_j):
    model = tfm.Transformer(CFG, device="cpu")
    model.load_state_dict(convert.params_from_jax(tree_j))
    return model


@pytest.fixture(scope="module")
def params():
    """(reference tree, port model) of the same weights."""
    pj = tfm_j.init_params(jax.random.PRNGKey(0), CFG_J,
                           tfm_j.ParallelConfig())
    return pj, _port(pj)


def _engines(params, slots=3, max_len=CFG.seq_len, draft_layers=0, k=3,
             **kw):
    """(reference engine, port engine) on the same weights."""
    pj, pt = params
    kw = dict(slots=slots, page_tokens=PAGE, max_len=max_len, **kw)
    dj = dt = None
    if draft_layers:
        dj = spec_j.DraftSpec(cfg=tfm_j.draft_config(CFG_J, draft_layers),
                              params=tfm_j.draft_params_from(
                                  pj, draft_layers), k=k)
        dt = spec_t.DraftSpec(cfg=tfm.draft_config(CFG, draft_layers),
                              params=tfm.draft_params_from(
                                  pt, draft_layers), k=k)
    return (eng_j.DecodeEngine(CFG_J, pj, draft=dj, **kw),
            eng_t.DecodeEngine(CFG, pt, draft=dt, **kw))


def _schedules(seed, n, **kw):
    kw.setdefault("vocab", CFG.vocab_size)
    sj = load_j.synthetic_workload(seed, n, 0.0, **kw)
    st = load_t.synthetic_workload(seed, n, 0.0, **kw)
    assert [(a, r.id, r.prompt, r.max_new_tokens) for a, r in sj] == \
        [(a, r.id, r.prompt, r.max_new_tokens) for a, r in st]
    return sj, st


def _outputs(result):
    return {rid: (r.get("tokens"), r.get("reason"), r.get("shed"))
            for rid, r in result["results"].items()}


def _stats(engine):
    """The engine statistics both packages define, minus wall clocks."""
    s = dict(engine.stats())
    s.pop("swaps", None)
    s.pop("trace_spans", None)
    return s


def _drive_both(params, sched_kw, continuous=True, engine_kw=None):
    ej, et = _engines(params, **(engine_kw or {}))
    sj, st = _schedules(**sched_kw)
    out_j = load_j.drive(ej, sj, continuous=continuous)
    out_t = load_t.drive(et, st, continuous=continuous)
    assert _outputs(out_t) == _outputs(out_j)
    assert out_t["iters"] == out_j["iters"]
    assert out_t["tokens"] == out_j["tokens"]
    assert _stats(et) == _stats(ej)
    return ej, et, out_j, out_t


@pytest.mark.parametrize("continuous", [True, False])
def test_drive_matches_reference(params, continuous):
    """test_admission_never_recompiles' schedule, continuous and static:
    one decode shape key, at most three prompt buckets, every slot and
    page returned."""
    ej, et, _, out_t = _drive_both(
        params, dict(seed=1, n=10, prompt_lens=(3, 20), output_lens=(2, 9)),
        continuous=continuous)
    assert len([r for r in out_t["results"].values() if "tokens" in r]) \
        == 10
    assert et.decode_traces == 1 and et.prefill_traces <= 3
    # One iteration latency a decode token (the first comes from prefill).
    assert len(et.token_latency_samples) == out_t["tokens"] - 10
    assert len(et.ttft_samples) == 10
    assert et.free_slots() == 3
    assert et.free_pages() == 3 * et.pages_per_slot


def test_continuous_beats_static_and_equals_it(params):
    sched = dict(seed=3, n=12, prompt_lens=(4, 12), output_lens=(2, 12))
    kw = dict(slots=4)
    _, _, _, cont = _drive_both(params, sched, True, kw)
    _, _, _, stat = _drive_both(params, sched, False, kw)
    assert cont["occupancy"] > stat["occupancy"]
    assert _outputs(cont) == _outputs(stat)


def _shared_prefix_schedule(cls, seed=5, n=8):
    """Requests whose prompts share one of two 16-token prefixes (and a
    few tokens past a page boundary: copy-on-write), seeded suffixes."""
    rng = np.random.default_rng(seed)
    heads = [list(rng.integers(0, 64, 19)) for _ in range(2)]
    out = []
    for i in range(n):
        head = heads[i % 2][:16 + (i % 4)]
        tail = list(rng.integers(0, 64, int(rng.integers(1, 6))))
        out.append((0.0, cls(id=f"p{i}", prompt=[int(t) for t in
                                                 head + tail],
                             max_new_tokens=int(rng.integers(2, 7)),
                             submit_seq=i)))
    return out


@pytest.mark.parametrize("chunk", [0, 4])
def test_prefix_cache_on_equals_off_and_reference(params, chunk):
    results = {}
    for cache in (True, False):
        ej, et = _engines(params, slots=2, prefix_cache=cache,
                          prefill_chunk=chunk)
        out_j = load_j.drive(ej, _shared_prefix_schedule(eng_j.Request))
        out_t = load_t.drive(et, _shared_prefix_schedule(eng_t.Request))
        assert _outputs(out_t) == _outputs(out_j)
        assert _stats(et) == _stats(ej)
        results[cache] = _outputs(out_t)
        if cache:
            assert et.stats()["prefix_cache"]["hits"] > 0
    assert results[True] == results[False]


def _greedy(engine, prompt, n=5, rid="r", **req_kw):
    cls = (eng_t.Request if isinstance(engine, eng_t.DecodeEngine)
           else eng_j.Request)
    out, done = [], False
    evs = engine.admit(cls(id=rid, prompt=list(prompt), max_new_tokens=n,
                           **req_kw))
    while True:
        for e in evs:
            if e.request.id != rid:
                continue
            if e.kind == "token":
                out.append(e.token)
            elif e.kind == "finish":
                done = True
        if done:
            return out
        evs = engine.step()


def test_prefix_cache_page_accounting_matches_reference(params):
    """test_prefix_cache_bit_identity_and_page_accounting and
    test_full_pool_admission_evicts_exactly_the_shortfall, on both."""
    engines = _engines(params, slots=2, max_len=32, prefix_cache=True)
    div = PROMPT[:11] + [30, 31, 32]
    for e in engines:
        for rid, prompt in (("cold", PROMPT), ("warm", PROMPT),
                            ("div", div), ("p1", [21] * 17),
                            ("p2", [22] * 17)):
            e.__dict__.setdefault("outs", []).append(
                _greedy(e, prompt, rid=rid))
        e.outs.append([ev.token for ev in e.admit(
            (eng_t.Request if e is engines[1] else eng_j.Request)(
                id="held", prompt=[23] * 17, max_new_tokens=5))
            if ev.kind == "token"])
        e.outs.append(_greedy(e, PROMPT, rid="again"))
    ej, et = engines
    assert et.outs == ej.outs
    assert _stats(et) == _stats(ej)
    cs = et.stats()["prefix_cache"]
    assert cs["hits"] >= 3 and cs["evictions"] >= 1


def test_chunked_prefill_backlog_matches_reference(params):
    engines = _engines(params, slots=2, max_len=32, prefill_chunk=4,
                       prefix_cache=False)
    outs = []
    for e in engines:
        cls = eng_t.Request if e is engines[1] else eng_j.Request
        evs = e.admit(cls(id="c", prompt=list(PROMPT), max_new_tokens=5))
        assert evs == [] and e.prefill_backlog() == len(PROMPT) - 4
        out, done = [], False
        while not done:
            for ev in e.step():
                if ev.kind == "token":
                    out.append((ev.token, ev.first))
                elif ev.kind == "finish":
                    done = True
        outs.append(out)
    assert outs[1] == outs[0]
    assert _stats(engines[1]) == _stats(engines[0])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("draft_layers", [0, 1])
def test_sampling_and_speculation_match_reference(params, temperature,
                                                  draft_layers):
    """Greedy and seeded sampling (draw for draw), each with and without
    a 1-layer self-draft at k 3: every request's tokens and the
    speculative counters equal the reference's; greedy speculation equals
    plain greedy."""
    def sched(cls):
        rng = np.random.default_rng(11)
        return [(0.0, cls(id=f"s{i}", prompt=[int(t) for t in rng.integers(
            0, 64, int(rng.integers(3, 14)))],
            max_new_tokens=int(rng.integers(3, 9)), temperature=temperature,
            seed=100 + i, submit_seq=i)) for i in range(6)]

    ej, et = _engines(params, slots=3, draft_layers=draft_layers)
    out_j = load_j.drive(ej, sched(eng_j.Request))
    out_t = load_t.drive(et, sched(eng_t.Request))
    assert _outputs(out_t) == _outputs(out_j)
    assert _stats(et) == _stats(ej)
    if draft_layers:
        assert et.stats()["speculative"]["proposed"] > 0
        assert et.verify_traces >= 1
        if temperature == 0.0:
            _, plain = _engines(params, slots=3)
            assert _outputs(load_t.drive(plain, sched(eng_t.Request))) == \
                _outputs(out_t)


def test_hot_swap_matches_reference_and_cold_engine(params):
    """A swap parked between iterations serves the new weights exactly as
    a cold engine on them does (seeded sampling, so that the weights show
    in the tokens: a random-init model's greedy stream repeats its last
    token whatever the weights)."""
    pj2 = tfm_j.init_params(jax.random.PRNGKey(1), CFG_J,
                            tfm_j.ParallelConfig())
    pt2 = tfm._tree(_port(pj2))
    ej, et = _engines(params, slots=2, prefix_cache=True)
    sample = dict(temperature=1.0, seed=3)
    before = [_greedy(e, PROMPT, **sample) for e in (ej, et)]
    ej.swap_params(pj2, tag=2)
    et.swap_params(pt2, tag=2)
    hot = [_greedy(e, PROMPT, rid="h", **sample) for e in (ej, et)]
    assert before[1] == before[0] and hot[1] == hot[0]
    assert et.params_tag == 2 and et.swaps == 1
    assert et.stats()["prefix_cache"]["flushes"] == 1
    assert et._params is pt2
    cold = eng_t.DecodeEngine(CFG, pt2, slots=2, page_tokens=PAGE,
                              max_len=CFG.seq_len, params_tag=2)
    assert _greedy(cold, PROMPT, rid="c", **sample) == hot[1]
    assert hot[1] != before[1]


@pytest.mark.parametrize("draft_layers", [0, 1])
def test_export_adopt_resumes_token_for_token(params, draft_layers):
    """A request exported after its prefill and adopted by a second port
    engine continues exactly as the reference's engine decodes it alone;
    the exported state and pages equal the reference's export."""
    ej, src = _engines(params, slots=2, prefix_cache=False,
                       draft_layers=draft_layers)
    _, dst = _engines(params, slots=2, prefix_cache=False,
                      draft_layers=draft_layers)
    want = _greedy(ej, PROMPT, rid="ref", temperature=0.7, seed=9)
    toks = [e.token for e in src.admit(eng_t.Request(
        id="m", prompt=list(PROMPT), max_new_tokens=5, temperature=0.7,
        seed=9)) if e.kind == "token"]
    ej2, _ = _engines(params, slots=2, prefix_cache=False)
    ej2.admit(eng_j.Request(id="m", prompt=list(PROMPT), max_new_tokens=5,
                            temperature=0.7, seed=9))
    state_j, kj, vj = ej2.export_request("m")
    state, k_pages, v_pages = src.export_request("m")
    assert state == state_j
    np.testing.assert_allclose(k_pages, kj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v_pages, vj, rtol=1e-5, atol=1e-6)
    src.release_request("m")
    assert src.active() == 0 and src.free_pages() == 2 * src.pages_per_slot
    dst.adopt_request(state, k_pages, v_pages)
    done = False
    while not done:
        for e in dst.step():
            if e.kind == "token":
                toks.append(e.token)
            elif e.kind == "finish":
                done = True
    assert toks == want


def test_geometry_validation_and_loud_refusals(params):
    _, pt = params
    e = eng_t.DecodeEngine(CFG, pt, slots=1, page_tokens=PAGE, max_len=60)
    assert e.max_len == 56 and e.pages_per_slot == 7
    with pytest.raises(ValueError):
        eng_t.DecodeEngine(CFG, pt, slots=1, page_tokens=PAGE, max_len=4)
    starved = eng_t.DecodeEngine(CFG, pt, slots=1, page_tokens=PAGE,
                                 total_pages=1)
    with pytest.raises(RuntimeError):
        starved.admit(eng_t.Request(id="a", prompt=list(range(20)),
                                    max_new_tokens=30))
    assert starved.free_pages() == 1 and starved.free_slots() == 1
    with pytest.raises(ValueError):
        spec_t.DraftSpec(cfg=tfm.draft_config(CFG, 1)._replace(
            vocab_size=32), params=None, k=2).validate(CFG, 32)


def test_env_knobs_reach_engine(params, monkeypatch):
    monkeypatch.setenv("HVD_TPU_SERVING_PREFIX_CACHE", "0")
    monkeypatch.setenv("HVD_TPU_SERVING_PREFILL_CHUNK", "6")
    monkeypatch.setenv("HVD_TPU_SERVING_SLOTS", "0")         # clamped
    e = eng_t.DecodeEngine(CFG, params[1], page_tokens=PAGE, max_len=32)
    assert e.prefix_cache is None and e.prefill_chunk == 6
    assert e.slots == 1
    st = e.stats()
    assert "prefix_cache" not in st and st["prefill_chunk"] == 6
