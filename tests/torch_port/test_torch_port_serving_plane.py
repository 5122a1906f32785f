"""The port's serving request plane against horovod_tpu's: the admission
policy's plans on seeded ``RequestView`` sets, the radix trie's lifecycle
under seeded operation sequences, tracing ids and sampling, SLO burn
rates, the serving knobs' defaults and clamps; an HTTP round trip with
HMAC, streaming, shedding and duplicate ids on a port engine (tokens equal
to the reference engine's); ``load_params`` of a step the reference wrote
and of one the port wrote (each read by the other package too); and the
watcher hot-swapping a newly committed step.  The reference's test
configuration (vocab 64, d_model 32, 4 heads, d_ff 64, 2 layers, seq 64,
fp32, pages of 8), on the CPU."""

import json
import queue
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as hvd_j
from horovod_tpu.models import transformer as tfm_j
from horovod_tpu.serving import engine as eng_j
from horovod_tpu.serving import policy as policy_j
from horovod_tpu.serving import prefix as prefix_j
from horovod_tpu.serving import slo as slo_j
from horovod_tpu.serving import tracing as tracing_j
from horovod_tpu.serving.service import load_params as load_params_j
from horovod_tpu_torch import convert
from horovod_tpu_torch.core import config
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.runner.rendezvous import _signature
from horovod_tpu_torch.serving import (CheckpointWatcher, DecodeEngine,
                                       Request, ServingServer, drive,
                                       load_params, save_params)
from horovod_tpu_torch.serving import engine as eng_t
from horovod_tpu_torch.serving import policy as policy_t
from horovod_tpu_torch.serving import prefix as prefix_t
from horovod_tpu_torch.serving import slo as slo_t
from horovod_tpu_torch.serving import submit
from horovod_tpu_torch.serving import tracing as tracing_t

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=64, remat=False)
CFG_J = tfm_j.TransformerConfig(dtype=jnp.float32, **SMALL)
CFG = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
PAGE = 8


@pytest.fixture(scope="module")
def params():
    pj = tfm_j.init_params(jax.random.PRNGKey(0), CFG_J,
                           tfm_j.ParallelConfig())
    model = tfm.Transformer(CFG, device="cpu")
    model.load_state_dict(convert.params_from_jax(pj))
    return pj, model


def _engine(model, slots=2, **kw):
    return DecodeEngine(CFG, model, slots=slots, page_tokens=PAGE,
                        max_len=CFG.seq_len, **kw)


def _greedy(engine, prompt, n, cls=Request):
    evs = engine.admit(cls(id="g", prompt=list(prompt), max_new_tokens=n))
    toks = [e.token for e in evs if e.kind == "token"]
    while not any(e.kind == "finish" for e in evs):
        evs = engine.step()
        toks += [e.token for e in evs if e.kind == "token"]
    return toks


# ---------------------------------------------------------------------------
# Pure planes: policy, trie, tracing, SLO, knobs
# ---------------------------------------------------------------------------

def _views(cls, seed, n=12):
    rng = np.random.default_rng(seed)
    return [cls(id=f"r{i}", tenant=f"t{int(rng.integers(0, 3))}",
                priority=int(rng.integers(0, 3)), submit_seq=i,
                arrival_s=float(rng.uniform(0, 10)),
                deadline_s=float(rng.choice([0.0, 2.0, 8.0])),
                pages_needed=int(rng.integers(1, 9)),
                prompt_tokens=int(rng.integers(1, 40)))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_policy_plans_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    kw = dict(free_slots=int(rng.integers(0, 6)),
              free_pages=int(rng.integers(0, 30)),
              now_s=float(rng.uniform(0, 12)),
              running={"t0": int(rng.integers(0, 3)), "t2": 1},
              queue_cap=int(rng.choice([0, 4, 8])),
              slot_pages=int(rng.choice([0, 6])),
              aging_s=float(rng.choice([0.0, 3.0])),
              prefill_budget=int(rng.choice([0, 30])),
              burn={"t1": float(rng.uniform(0, 2))},
              burn_threshold=1.0)
    want = policy_j.plan(_views(policy_j.RequestView, seed), **kw)
    got = policy_t.plan(_views(policy_t.RequestView, seed), **kw)
    assert got == want


def _trie_run(mod, seed):
    """A seeded sequence of insert / match+acquire / release / evict /
    flush on one trie; returns everything it observed."""
    rng = np.random.default_rng(seed)
    c = mod.RadixPrefixCache(2)
    held, seen, page = [], [], 100
    for _ in range(60):
        op = int(rng.integers(0, 5))
        toks = [int(t) for t in rng.integers(0, 3, int(rng.integers(1, 7)))]
        if op == 0:
            path, partial = c.match(toks)
            n_full = len(toks) // 2
            chunks = [tuple(toks[2 * i:2 * i + 2])
                      for i in range(len(path), n_full)]
            c.acquire(path)
            nodes, dups = c.insert(path[-1] if path else None, chunks,
                                   list(range(page, page + len(chunks))))
            page += len(chunks)
            held.append(path + nodes)
            seen.append(("ins", [n.page for n in path + nodes], dups,
                         None if partial is None else
                         (partial[0].page, partial[1])))
        elif op == 1 and held:
            seen.append(("rel", c.release(held.pop(int(
                rng.integers(0, len(held)))))))
        elif op == 2:
            seen.append(("evict", c.evict(int(rng.integers(1, 4)))))
        elif op == 3:
            seen.append(("flush", sorted(c.flush())))
        else:
            path, partial = c.match(toks)
            seen.append(("match", [n.page for n in path],
                         None if partial is None else
                         (partial[0].page, partial[1])))
        seen.append(("stats", c.stats()))
    return seen


@pytest.mark.parametrize("seed", range(3))
def test_trie_lifecycle_matches_reference(seed):
    assert _trie_run(prefix_t, seed) == _trie_run(prefix_j, seed)


def test_trie_refcount_lifecycle():
    c = prefix_t.RadixPrefixCache(4)
    toks = list(range(12))
    chunks = [tuple(toks[i:i + 4]) for i in range(0, 12, 4)]
    nodes, dups = c.insert(None, chunks, [10, 11, 12])
    assert [n.page for n in nodes] == [10, 11, 12] and not dups
    path, partial = c.match(toks)
    c.acquire(path)
    assert c.release(nodes) == [] and c.evictable() == 0
    assert c.release(path) == [] and c.evictable() == 3
    with pytest.raises(RuntimeError):
        c.release(path)
    assert c.evict(2) == [12, 11]


def test_tracing_matches_reference(monkeypatch):
    monkeypatch.setenv("HVD_TPU_TRACE_SEED", "7")
    for rid in ("a", "r00017", "req00000042"):
        for rate in (0.0, 0.3, 1.0):
            want = tracing_j.mint(rid, rate=rate)
            got = tracing_t.mint(rid, rate=rate)
            assert (got.trace_id, got.span_id, got.sampled) == \
                (want.trace_id, want.span_id, want.sampled)
            assert got.header() == want.header()
    for h in ("0" * 32 + "-" + "1" * 16 + "-01", "bad", None,
              "g" * 32 + "-" + "1" * 16 + "-00", "a" * 32 + "-b-01"):
        want, got = tracing_j.parse_header(h), tracing_t.parse_header(h)
        assert (None if got is None else got.header()) == \
            (None if want is None else want.header())
    ctx = tracing_t.mint("x", rate=1.0)
    assert tracing_t.from_state(tracing_t.to_state(ctx)) == ctx
    assert tracing_t.from_state({"trace_id": "zz"}) is None
    unsampled = tracing_t.mint("y", rate=0.0)
    tracing_t.span(ctx, "admit", slot=1)
    tracing_t.span(unsampled, "admit")
    assert tracing_t.spans(ctx.trace_id)[-1] == (
        "admit", ctx.trace_id, tracing_t.derive_span_id(ctx.trace_id,
                                                        "admit"),
        ctx.span_id, {"slot": 1})
    assert tracing_t.spans(unsampled.trace_id) == []


def test_slo_matches_reference():
    for good, bad, target in ((0, 0, 0.99), (99, 1, 0.99), (5, 5, 0.9),
                              (3, 1, 1.0), (4, 0, 1.0)):
        assert slo_t.burn_rate(good, bad, target) == \
            slo_j.burn_rate(good, bad, target)
        assert slo_t.budget_remaining(good, bad, target) == \
            slo_j.budget_remaining(good, bad, target)
    tj = slo_j.SloTracker(target=0.9, window_s=10.0, burn_threshold=1.0)
    tt = slo_t.SloTracker(target=0.9, window_s=10.0, burn_threshold=1.0)
    rng = np.random.default_rng(0)
    for i in range(40):
        args = (f"t{i % 3}", bool(rng.uniform() < 0.8), i * 0.5,
                f"tr{i}")
        tj.record(*args)
        tt.record(*args)
        assert tt.burn_rates(i * 0.5) == tj.burn_rates(i * 0.5)
    assert tt.stats(20.0) == tj.stats(20.0)
    assert tt.burning(20.0) == tj.burning(20.0)
    assert tt.gauges["t0"]["burn_rate"] == tj.burn("t0", 19.5)


def test_serving_knobs_defaults_and_clamps(monkeypatch):
    from horovod_tpu.core.config import Config
    defaults = Config.from_env()
    pairs = {  # port function: reference Config field
        "serving_port": "serving_port", "serving_slots": "serving_slots",
        "serving_page_tokens": "serving_page_tokens",
        "serving_max_len": "serving_max_len",
        "serving_max_new_tokens": "serving_max_new_tokens",
        "serving_queue_cap": "serving_queue_cap",
        "serving_swap_poll_s": "serving_swap_poll_s",
        "serving_prefix_cache": "serving_prefix_cache",
        "serving_prefill_chunk": "serving_prefill_chunk",
        "serving_aging_s": "serving_aging_s",
        "serving_slo_ttft_s": "serving_slo_ttft_s", "spec_k": "spec_k",
        "trace_sample": "trace_sample", "trace_seed": "trace_seed",
        "slo_target": "slo_target", "slo_window_s": "slo_window_s",
        "slo_burn_threshold": "slo_burn_threshold"}
    for fn, field in pairs.items():
        assert getattr(config, fn)() == getattr(defaults, field), fn
    for name, val in (("SERVING_SLOTS", "0"), ("SERVING_PAGE_TOKENS", "32"),
                      ("SERVING_QUEUE_CAP", "0"),
                      ("SERVING_SWAP_POLL_S", "0.0"),
                      ("SERVING_PREFIX_CACHE", "0"),
                      ("SERVING_PREFILL_CHUNK", "-5"),
                      ("SERVING_AGING_S", "-1"), ("SPEC_K", "99"),
                      ("TRACE_SAMPLE", "3"), ("SLO_TARGET", "0.1"),
                      ("SERVING_MAX_NEW_TOKENS", "0")):
        monkeypatch.setenv("HVD_TPU_" + name, val)
    clamped = Config.from_env()
    for fn, field in pairs.items():
        assert getattr(config, fn)() == getattr(clamped, field), fn
    assert config.serving_slots() == 1 and config.spec_k() == 32


# ---------------------------------------------------------------------------
# The request plane over HTTP
# ---------------------------------------------------------------------------

def test_http_roundtrip_stream_auth_and_client(params):
    pj, model = params
    want = _greedy(eng_j.DecodeEngine(CFG_J, pj, slots=2, page_tokens=PAGE,
                                      max_len=CFG.seq_len),
                   [5, 6, 7], 4, cls=eng_j.Request)
    srv = ServingServer(_engine(model), port=0, secret="s3cret",
                        queue_cap=8)
    port = srv.serve()
    addr = f"127.0.0.1:{port}"
    try:
        h = json.loads(urllib.request.urlopen(
            f"http://{addr}/serve/healthz", timeout=5).read())
        assert h["service"] == "horovod_tpu_serving" and h["ok"]
        body = json.dumps({"tokens": [1, 2, 3]}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}/serve/generate", data=body), timeout=5)
        assert ei.value.code == 403
        with pytest.raises(urllib.error.HTTPError) as ei:
            submit.generate({"tokens": [1, 2]}, server=addr, secret="bad")
        assert ei.value.code == 403
        out = submit.generate({"tokens": [5, 6, 7], "max_new_tokens": 4},
                              server=addr, secret="s3cret")
        assert out["tokens"] == want and out["reason"] == "length"
        assert out["ttft_s"] is not None
        body = json.dumps({"tokens": [5, 6, 7], "max_new_tokens": 4,
                           "stream": True}).encode()
        req = urllib.request.Request(f"http://{addr}/serve/generate",
                                     data=body)
        req.add_header("X-HVD-Signature", _signature(
            "s3cret", "POST", "serve", "generate", body))
        lines = [json.loads(l) for l in urllib.request.urlopen(req,
                                                                timeout=30)]
        toks = [l["token"] for l in lines if "token" in l]
        assert toks == want and lines[-1]["done"]
        assert lines[-1]["tokens"] == toks and "ttft_s" in lines[0]
        sig = _signature("s3cret", "GET", "serve", "stats")
        stats = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://{addr}/serve/stats", headers={
                "X-HVD-Signature": sig}), timeout=5).read())
        assert stats["decode_traces"] == 1 and stats["tokens_out"] == 8
        # The load client: a seeded schedule through the same endpoint.
        assert submit.main(["--server", addr, "--secret", "s3cret",
                            "--requests", "4", "--rate", "0",
                            "--prompt-len", "3,9", "--max-tokens", "2,4",
                            "--vocab", "64"]) == 0
    finally:
        srv.close()


def test_overload_shed_is_loud(params):
    srv = ServingServer(_engine(params[1], slots=1), port=0, secret=None,
                        queue_cap=1)
    shed0 = eng_t.plane_counters()["shed"].get("overload", 0)
    ok1 = srv.submit(Request(id="q1", prompt=[1], max_new_tokens=2,
                             arrival_mono=time.monotonic()), queue.Queue())
    ok2 = srv.submit(Request(id="q2", prompt=[1], max_new_tokens=2,
                             arrival_mono=time.monotonic()), queue.Queue())
    assert ok1 and not ok2
    assert eng_t.plane_counters()["shed"]["overload"] == shed0 + 1
    assert eng_t.recent_sheds[-1] == ("q2", "default", "overload")
    assert eng_t.plane_counters()["queue_depth"] == 1
    srv.stop()


def test_duplicate_request_ids_survive(params):
    srv = ServingServer(_engine(params[1]), port=0, secret=None,
                        queue_cap=8)
    srv.serve()
    try:
        addr = f"127.0.0.1:{srv.port}"
        outs = [None, None]

        def _go(i):
            outs[i] = submit.generate({"id": "dup", "tokens": [1, 2, 3],
                                       "max_new_tokens": 4}, server=addr)
        ts = [threading.Thread(target=_go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert all(o and len(o["tokens"]) == 4 for o in outs), outs
        assert srv._loop_thread.is_alive()
        assert outs[0]["tokens"] == outs[1]["tokens"]
        assert sorted(o["id"] for o in outs)[0] == "dup"
    finally:
        srv.close()


def test_oversized_request_sheds_not_livelocks(params):
    eng = _engine(params[1], total_pages=2)
    reqs = [(0.0, Request(id="big", prompt=list(range(10)),
                          max_new_tokens=20, submit_seq=0)),
            (0.0, Request(id="ok", prompt=[1, 2], max_new_tokens=4,
                          submit_seq=1))]
    out = drive(eng, reqs, continuous=True)
    assert out["results"]["big"]["shed"] in ("too_large", "capacity")
    assert out["results"]["ok"]["tokens"]


# ---------------------------------------------------------------------------
# The train→serve loop: checkpoints across packages, the watcher
# ---------------------------------------------------------------------------

def _equal_trees(port_tree, ref_tree):
    for k, v in ref_tree.items():
        if isinstance(v, dict):
            _equal_trees(port_tree[k], v)
        else:
            np.testing.assert_array_equal(port_tree[k].numpy(),
                                          np.asarray(v))


def test_load_params_across_packages(params, tmp_path):
    pj, model = params
    hvd_j.init()
    from horovod_tpu.checkpoint import save_zero_state as save_j
    like = tfm.init_params(CFG, tfm.ParallelConfig(),
                           torch.Generator().manual_seed(9))
    ref_dir = str(tmp_path / "ref")
    save_j(ref_dir, pj, step=3)
    got, step = load_params(ref_dir, like, device="cpu")
    assert step == 3
    _equal_trees(got, pj)
    port_dir = str(tmp_path / "port")
    save_params(port_dir, model, step=5)
    got, step = load_params(port_dir, model, device="cpu")
    assert step == 5 and got["embed"] is not model.embed
    _equal_trees(got, pj)
    like_j = tfm_j.init_params(jax.random.PRNGKey(9), CFG_J,
                               tfm_j.ParallelConfig())
    ref_got, ref_step = load_params_j(port_dir, like_j)
    assert ref_step == 5
    _equal_trees(got, ref_got)
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "none"), like, device="cpu")


def test_watcher_thread_picks_up_commit(params, tmp_path):
    _, model = params
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, model, step=1)
    p1, s1 = load_params(ckpt, model, device="cpu")
    eng = _engine(p1, params_tag=s1)
    w = CheckpointWatcher(eng, ckpt, model, poll_s=0.05)
    assert w.current_step == 1 and w.check_once() is None
    w.start()
    try:
        scaled = {k: v * 1.5 if not isinstance(v, dict) else
                  {kk: vv * 1.5 for kk, vv in v.items()}
                  for k, v in tfm._tree(model).items()}
        save_params(ckpt, scaled, step=2)
        deadline = time.monotonic() + 10
        while w.current_step != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert w.current_step == 2
        eng.step()   # applies the parked swap
        assert eng.params_tag == 2 and eng.swaps == 1
        assert torch.equal(eng._params["layers"]["wqkv"],
                           scaled["layers"]["wqkv"].detach())
    finally:
        w.stop()
