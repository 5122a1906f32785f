"""horovod_tpu_torch.serving.disagg and .autoscale against horovod_tpu's.

The bundle codec: ``encode_bundle`` writes the same bytes in both
packages on the fp32, int8 and int4 wires, each package decodes the
other's bundle, and a flipped byte, a torn tail or a bad magic raise;
``wire_ratio`` equals the reference's.  The migration: on the
reference's test configuration (vocab 64, d_model 32, 2 layers, fp32,
pages of 8; its weights through ``convert.params_from_jax``) a request
prefilled on one port engine and migrated over the recovery transport's
one-shot mailbox (fp32 wire) resumes token for token against the
reference's unmigrated output; a failed push under the signed
transport keeps the source slot; the int8 wire shrinks the payload and
a half-prefilled export is refused.  The knobs clamp as the
reference's do, ``desired_np`` equals the reference's over a grid of
inputs and ``Autoscaler`` makes the reference's calls on a fake
driver."""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as tfm_j
from horovod_tpu.serving import disagg as dis_j
from horovod_tpu.serving import engine as eng_j
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.serving import disagg as dis_t
from horovod_tpu_torch.serving import engine as eng_t

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=64, remat=False)
CFG_J = tfm_j.TransformerConfig(dtype=jnp.float32, **SMALL)
CFG = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
PAGE = 8
PROMPT = [5, 9, 13, 2, 7, 11, 3, 1, 6, 4, 12, 8, 10, 14, 15, 16, 17]
N_OUT = 5
BITS = (0, 4, 8)


@pytest.fixture(scope="module")
def params():
    """(reference tree, port model) of the same weights."""
    pj = tfm_j.init_params(jax.random.PRNGKey(0), CFG_J,
                           tfm_j.ParallelConfig())
    model = tfm.Transformer(CFG, device="cpu")
    model.load_state_dict(convert.params_from_jax(pj))
    return pj, model


def _engine(params, pkg="port", slots=2, **kw):
    kw.setdefault("prefix_cache", False)
    pj, pt = params
    if pkg == "ref":
        return eng_j.DecodeEngine(CFG_J, pj, slots=slots, page_tokens=PAGE,
                                  max_len=32, **kw)
    return eng_t.DecodeEngine(CFG, pt, slots=slots, page_tokens=PAGE,
                              max_len=32, **kw)


def _finish(engine, toks):
    done = False
    while not done:
        for e in engine.step():
            if e.kind == "token":
                toks.append(e.token)
            elif e.kind == "finish":
                done = True
    return toks


@pytest.fixture(scope="module")
def ref_out(params):
    """The reference engine's unmigrated greedy output."""
    e = _engine(params, "ref")
    evs = e.admit(eng_j.Request(id="r", prompt=list(PROMPT),
                                max_new_tokens=N_OUT))
    return _finish(e, [ev.token for ev in evs if ev.kind == "token"])


def _state():
    return {"id": "m", "prompt": [1, 2, 3], "max_new_tokens": 4,
            "eos_id": None, "tenant": "default", "priority": 0,
            "deadline_s": 0.0, "temperature": 0.0, "seed": 0,
            "submit_seq": 1, "generated": [7], "length": 4,
            "rng_state": None, "spec_rng_state": None}


def _pages(seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 3, PAGE, 4, 8)).astype(np.float32)
                 for _ in range(2))


# ---------------------------------------------------------------------------
# the bundle codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_bundle_bytes_equal_and_cross_decode(bits):
    k, v = _pages()
    blob_t = dis_t.encode_bundle(_state(), k, v, bits=bits)
    blob_j = dis_j.encode_bundle(_state(), k, v, bits=bits)
    assert blob_t == blob_j
    # The port's tensors in, the same bytes out.
    assert dis_t.encode_bundle(_state(), torch.from_numpy(k),
                               torch.from_numpy(v), bits=bits) == blob_j
    s_t, k_t, v_t = dis_t.decode_bundle(blob_j)      # the reference's
    s_j, k_j, v_j = dis_j.decode_bundle(blob_t)      # the port's
    assert s_t == s_j == _state()
    assert isinstance(k_t, np.ndarray) and k_t.dtype == np.float32
    np.testing.assert_array_equal(k_t, np.asarray(k_j))
    np.testing.assert_array_equal(v_t, np.asarray(v_j))
    if bits == 0:
        np.testing.assert_array_equal(k_t, k)         # fp32 is exact
    else:
        # Within half a grid step of each block's scale (and the fp32
        # roundings of the scale and the product).
        absmax = np.abs(k).reshape(-1, 256).max(axis=1)
        step = absmax / (127 if bits == 8 else 7)
        err = np.abs(k_t - k).reshape(-1, 256).max(axis=1)
        assert np.all(err <= 0.5 * step + 2 * np.finfo(np.float32).eps
                      * absmax)


@pytest.mark.parametrize("fault", ["flipped_byte", "torn_tail",
                                   "bad_magic"])
def test_bundle_refuses_corruption(fault):
    k, v = _pages()
    blob = dis_t.encode_bundle(_state(), k, v, bits=0)
    if fault == "flipped_byte":
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        bad = bytes(bad)
    elif fault == "torn_tail":
        bad = blob[:-3]
    else:
        bad = b"nope" + blob[4:]
    for mod in (dis_t, dis_j):
        with pytest.raises(ValueError):
            mod.decode_bundle(bad)


@pytest.mark.parametrize("bits", BITS)
def test_wire_ratio_matches_reference(bits):
    for n in (1, 255, 256, 257, 3 * 8 * 4 * 8, 1 << 20):
        assert dis_t.wire_ratio(bits, n) == dis_j.wire_ratio(bits, n)
    assert dis_t.wire_ratio(bits, 1 << 20) == (
        1.0 if bits == 0 else 4 * 256 / (256 // (8 // bits) + 4))


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def test_migration_over_http_resumes_token_for_token(params, ref_out):
    from horovod_tpu_torch.recovery import transport
    src, dst = _engine(params), _engine(params)
    server = transport.RecoveryServer(host="127.0.0.1")
    addr = f"127.0.0.1:{server.start()}"
    try:
        evs = src.admit(eng_t.Request(id="m", prompt=list(PROMPT),
                                      max_new_tokens=N_OUT))
        toks = [e.token for e in evs if e.kind == "token"]
        nbytes = dis_t.send(src, "m", addr, bits=0)
        # The source slot frees only after the push lands.
        assert src.active() == 0 and src.free_pages() == 2 * 4
        assert dis_t.receive(dst, "m", addr)
        assert not dis_t.receive(dst, "m", addr)    # one-shot mailbox
        assert _finish(dst, toks) == ref_out        # token for token
        assert nbytes > 4 * 2 * CFG.n_layers * 3 * PAGE * CFG.d_model
    finally:
        server.stop()


def test_send_keeps_source_slot_on_failed_push(params, monkeypatch,
                                               ref_out):
    """Under the transport's secret, a push whose signature the server
    refuses raises and leaves the request on the source, which then
    migrates it once the push is signed right."""
    from horovod_tpu_torch.recovery import transport
    from horovod_tpu_torch.runner import rendezvous as rdv
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", "s3cret")
    monkeypatch.setenv("HVD_TPU_NET_HTTP_RETRIES", "1")
    src, dst = _engine(params), _engine(params)
    server = transport.RecoveryServer(host="127.0.0.1")
    addr = f"127.0.0.1:{server.start()}"
    signed = transport._sign
    try:
        evs = src.admit(eng_t.Request(id="f", prompt=list(PROMPT),
                                      max_new_tokens=N_OUT))
        toks = [e.token for e in evs if e.kind == "token"]
        monkeypatch.setattr(transport, "_sign", lambda req, m, key, b=b"":
                            req.add_header(rdv._SIG_HEADER, rdv._signature(
                                "wrong", m, "recovery", key, b)))
        with pytest.raises(RuntimeError, match="source slot retained"):
            dis_t.send(src, "f", addr, bits=8)
        assert src.active() == 1 and not dis_t.receive(dst, "f", addr)
        monkeypatch.setattr(transport, "_sign", signed)
        dis_t.send(src, "f", addr, bits=0)
        assert src.active() == 0
        assert dis_t.receive(dst, "f", addr)
        assert _finish(dst, toks) == ref_out
    finally:
        server.stop()


def test_int8_wire_shrinks_payload_and_half_prefill_refused(params):
    sizes = {}
    for pkg, mod, req in (("ref", dis_j, eng_j.Request),
                          ("port", dis_t, eng_t.Request)):
        src, dst = _engine(params, pkg), _engine(params, pkg)
        src.admit(req(id="q", prompt=list(PROMPT), max_new_tokens=N_OUT))
        sizes[pkg] = mod.migrate(src, "q", dst, bits=8)
        assert dst.active() == 1 and src.active() == 0
    raw = 4 * 2 * CFG.n_layers * 3 * PAGE * CFG.d_model   # k+v fp32
    assert sizes["port"] == sizes["ref"] < raw / 2.5
    half = _engine(params, prefill_chunk=4)
    half.admit(eng_t.Request(id="h", prompt=list(PROMPT),
                             max_new_tokens=N_OUT))
    with pytest.raises(ValueError):
        dis_t.migrate(half, "h", _engine(params), bits=8)
    assert half.active() == 1


# ---------------------------------------------------------------------------
# knobs and the autoscaler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob,value", [
    ("SERVING_MIGRATE_BITS", "7"), ("SERVING_MIGRATE_BITS", "4"),
    ("SERVING_MIGRATE_BITS", "0"), ("SERVING_MIGRATE_BITS", "x"),
    ("SERVING_TARGET_QUEUE", "-3"), ("SERVING_TARGET_QUEUE", "6.5"),
    ("SERVING_SCALE_COOLDOWN_S", "-1"), ("SERVING_SCALE_COOLDOWN_S", "2.5")])
def test_serving_knobs_clamp_as_the_reference(monkeypatch, knob, value):
    from horovod_tpu.core.config import Config
    from horovod_tpu_torch.core import config as cfg_t
    monkeypatch.setenv("HVD_TPU_" + knob, value)
    want = getattr(Config.from_env(), knob.lower())
    assert getattr(cfg_t, knob.lower())() == want
    if knob == "SERVING_MIGRATE_BITS":
        k, v = _pages()
        assert dis_t.encode_bundle(_state(), k, v) == \
            dis_j.encode_bundle(_state(), k, v)


def test_desired_np_matches_reference():
    from horovod_tpu.serving.autoscale import desired_np as want
    from horovod_tpu_torch.serving.autoscale import desired_np as got
    grid = itertools.product((1, 2, 4), (0, 1, 8, 9, 20), (4.0, 0.5),
                             (0.0, 0.4, 0.9, 2.0), (0.0, 1.0),
                             (0.0, 0.6), (0.0, 0.4, 1.2))
    n = 0
    for cur, q, tq, ttft, slo, occ, burn in grid:
        kw = dict(queue_depth=q, target_queue=tq, ttft_p95=ttft,
                  slo_ttft_s=slo, occupancy=occ, burn_rate=burn)
        assert got(cur, 1, 4, **kw) == want(cur, 1, 4, **kw), (cur, kw)
        n += 1
    assert n == 1440


class _FakeDriver:
    def __init__(self, accept=True):
        self.calls = []
        self.accept = accept

    def request_resize(self, np_, reason):
        self.calls.append((np_, reason))
        return self.accept


@pytest.mark.parametrize("accept", [True, False])
def test_autoscaler_drives_request_resize(accept):
    """The reference's drill on both packages: the same resizes, reasons
    and return values (a refused resize starts no cooldown)."""
    runs = []
    for pkg in ("horovod_tpu", "horovod_tpu_torch"):
        auto = importlib.import_module(f"{pkg}.serving.autoscale")
        drv = _FakeDriver(accept)
        status = {"np": 1, "queue_depth": 10, "ttft_p95": 0.0}
        a = auto.Autoscaler(drv, lambda: status, min_np=1, max_np=4,
                            target_queue=4.0, slo_ttft_s=0.0,
                            cooldown_s=100.0)
        out = [a.maybe_resize(now=1000.0), a.maybe_resize(now=1001.0)]
        status.update(np=2, queue_depth=0)
        out.append(a.maybe_resize(now=2000.0))
        status.update(np=2, queue_depth=0, occupancy=0.9)
        out.append(a.maybe_resize(now=3000.0))
        runs.append((out, drv.calls))
    assert runs[1] == runs[0]
    if accept:
        assert runs[1][0] == [2, None, 1, None]
        assert [c[0] for c in runs[1][1]] == [2, 1]
