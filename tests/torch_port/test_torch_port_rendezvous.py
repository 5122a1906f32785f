"""horovod_tpu_torch's rendezvous KV (``runner/rendezvous.py``) and replica
transport (``recovery/transport.py``) against horovod_tpu's, on the wire.

Under one ``HVD_TPU_RENDEZVOUS_SECRET``, each package's clients talk to
the other's servers: ``http_put``/``http_get``/``http_list``/
``http_delete`` against either ``RendezvousServer``, and
``push_replica``/``push_seal``/``fetch_replica`` and the KV-page mailbox
against either ``RecoveryServer``; the published replica endpoint is
found by either ``lookup_addr``.  A wrong or missing signature answers
403, which the KV clients raise as ``PermissionError`` in both
packages."""

import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu import net as net_jax
from horovod_tpu import recovery as rec_jax
from horovod_tpu.runner import rendezvous as rdv_jax
from horovod_tpu_torch import net as net_t
from horovod_tpu_torch import recovery as rec_t
from horovod_tpu_torch.runner import rendezvous as rdv_t

SECRET = "rendezvous-test-secret"
PACKAGES = {"port": (rdv_t, rec_t, net_t), "ref": (rdv_jax, rec_jax, net_jax)}
PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]
STORES = (sys.modules["horovod_tpu_torch.recovery.store"],
          sys.modules["horovod_tpu.recovery.store"])


@pytest.fixture(autouse=True)
def _quiet_wire(monkeypatch):
    """The secret set, no wire chaos, fresh schedules and stores."""
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", SECRET)
    monkeypatch.setenv("HVD_TPU_FLIGHT_HOST", "127.0.0.1")
    monkeypatch.delenv("HVD_TPU_RENDEZVOUS_ADDR", raising=False)
    for knob in ("SEED", "DROP_PCT", "RESET_PCT", "DELAY_MS", "TRUNCATE"):
        monkeypatch.delenv(f"HVD_TPU_CHAOS_NET_{knob}", raising=False)
    for _, rec, net in PACKAGES.values():
        net.reset_net_chaos()
        rec.reset_chaos()
    for mod in STORES:
        monkeypatch.setattr(mod, "_store", None)
    yield
    for _, rec, net in PACKAGES.values():
        net.reset_net_chaos()


def _server(pkg, secret=SECRET):
    s = PACKAGES[pkg][0].RendezvousServer(host="127.0.0.1", secret=secret)
    s.start()
    return s


def test_signature_and_gate_equal_reference():
    for args in (("PUT", "recovery", "replica", b"\x00payload"),
                 ("GET", "scope", "", b""), ("DELETE", "a/b", "c", b"")):
        assert rdv_t._signature(SECRET, *args) == \
            rdv_jax._signature(SECRET, *args)
        req_t = urllib.request.Request("http://127.0.0.1:1/x")
        req_j = urllib.request.Request("http://127.0.0.1:1/x")
        rdv_t.sign_request(req_t, *args)
        rdv_jax.sign_request(req_j, *args)
        assert req_t.header_items() == req_j.header_items()
        # What a server reads: urllib capitalises the name it sends.
        headers = {"X-HVD-Signature": req_t.get_header("X-hvd-signature")}
        assert rdv_t.request_authorized(headers, *args)
        assert rdv_jax.request_authorized(headers, *args)
        assert not rdv_t.request_authorized(headers, args[0], "other",
                                            *args[2:])
        assert not rdv_t.request_authorized({}, *args)
    assert rdv_t.advertised_host() == rdv_jax.advertised_host() == \
        "127.0.0.1"
    assert len(rdv_t.generate_secret()) == 32


@pytest.mark.parametrize("client,server", PAIRS)
def test_kv_across_packages(client, server, monkeypatch):
    rdv = PACKAGES[client][0]
    s = _server(server)
    skew = 1234.5
    monkeypatch.setattr(PACKAGES[server][0], "_now_wall", lambda: skew)
    addr = f"127.0.0.1:{s.port}"
    try:
        assert rdv.http_get(addr, "scope", "missing") is None
        assert rdv.http_put(addr, "scope", "k1", b"v1")
        assert rdv.http_put(addr, "scope", "k0", b"\x00\xff" * 300)
        assert rdv.http_put(addr, "other", "k9", b"")
        assert s.get("scope", "k1") == b"v1"
        assert rdv.http_get(addr, "scope", "k0") == b"\x00\xff" * 300
        assert rdv.http_get(addr, "other", "k9") == b""
        assert rdv.http_list(addr, "scope") == ["k0", "k1"]
        assert float(rdv.http_get(addr, "debug", "time")) == skew
        assert rdv.http_delete(addr, "scope", "k1")
        assert rdv.http_get(addr, "scope", "k1") is None
        assert rdv.http_list(addr, "scope") == ["k0"]
        s.put("scope", "direct", b"d")
        assert rdv.http_get(addr, "scope", "direct") == b"d"
    finally:
        s.stop()


@pytest.mark.parametrize("client,server", PAIRS)
@pytest.mark.parametrize("secret", ["wrong", None])
def test_wrong_or_missing_secret_is_refused(client, server, secret,
                                            monkeypatch):
    rdv = PACKAGES[client][0]
    s = _server(server)
    s.put("scope", "k", b"v")
    addr = f"127.0.0.1:{s.port}"
    if secret is None:
        monkeypatch.delenv("HVD_TPU_RENDEZVOUS_SECRET")
    try:
        with pytest.raises(PermissionError, match="rejected the request"):
            rdv.http_get(addr, "scope", "k", secret=secret)
        with pytest.raises(PermissionError, match="rejected the request"):
            rdv.http_put(addr, "scope", "k", b"x", secret=secret)
        assert not rdv.http_delete(addr, "scope", "k", secret=secret)
        with pytest.raises(PermissionError):
            rdv.http_list(addr, "scope", secret=secret)
        assert s.get("scope", "k") == b"v"
        req = urllib.request.Request(f"http://{addr}/scope/k")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 403
    finally:
        s.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_unsigned_server_accepts_unsigned_requests(pkg, monkeypatch):
    monkeypatch.delenv("HVD_TPU_RENDEZVOUS_SECRET")
    s = _server(pkg, secret=None)
    addr = f"127.0.0.1:{s.port}"
    try:
        assert rdv_t.http_put(addr, "s", "k", b"v")
        assert rdv_jax.http_get(addr, "s", "k") == b"v"
    finally:
        s.stop()


def _entry(rec, step=3, rank=1):
    rng = np.random.default_rng(step)
    arrays = {".inner[0].mu['w']": rng.standard_normal(37).astype(
        np.float32), ".inner[0].count": np.asarray(step, np.int32)}
    return rec.ReplicaEntry(
        key="opt_state", rank=rank, step=step, world=4,
        fingerprint="ab" * 32, manifest_json=json.dumps({"step": step}),
        arrays=arrays, checksum=rec.payload_checksum(arrays))


def _same_entry(a, b):
    assert (a.key, a.rank, a.step, a.world, a.fingerprint, a.manifest_json,
            a.checksum) == (b.key, b.rank, b.step, b.world, b.fingerprint,
                            b.manifest_json, b.checksum)
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype
        assert np.array_equal(a.arrays[k], b.arrays[k])


@pytest.mark.parametrize("client,server", PAIRS)
def test_replica_transport_across_packages(client, server, monkeypatch):
    rdv_c, rec_c, _ = PACKAGES[client]
    rec_s = PACKAGES[server][1]
    kv = _server(client)
    rdv_addr = f"127.0.0.1:{kv.port}"
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", rdv_addr)
    published = rec_s.transport.serve_and_publish(rank=2)
    try:
        assert published.startswith("127.0.0.1:")
        assert rec_c.transport.lookup_addr(2) == published
        assert rec_c.transport.lookup_addr(3, timeout=0.3) is None
        sent = _entry(rec_c)
        assert rec_c.transport.push_replica(published, sent)
        held = rec_s.store().contribution("opt_state", role="held")
        assert held == []                       # pending until sealed
        assert rec_c.transport.fetch_replica(published, "opt_state",
                                             1) is None
        assert rec_c.transport.push_seal(published, "opt_state", 3)
        (held,) = rec_s.store().contribution("opt_state", role="held")
        _same_entry(held, sent)
        assert rec_s.verify_entry(held)
        got = rec_c.transport.fetch_replica(published, "opt_state", 1)
        _same_entry(got, sent)
        assert rec_c.verify_entry(got) and got.sealed
        # The KV-page mailbox: a GET pops.
        assert rec_c.transport.push_kv(published, "req7", b"bundle")
        assert rec_c.transport.fetch_kv(published, "req7") == b"bundle"
        assert rec_c.transport.fetch_kv(published, "req7") is None
    finally:
        rec_s.transport.stop_serving()
        kv.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_replica_endpoint_refuses_bad_signatures(pkg):
    rec = PACKAGES[pkg][1]
    server = rec.transport.serve(port=0, host="127.0.0.1")
    addr = f"127.0.0.1:{server.port}"
    body = rec.entry_to_bytes(_entry(rec))
    try:
        for headers in ({}, {"X-HVD-Signature": rdv_t._signature(
                "wrong", "PUT", "recovery", "replica", body)}):
            req = urllib.request.Request(f"http://{addr}/recovery/replica",
                                         data=body, method="PUT",
                                         headers=headers)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 403
        # Signed for another payload: refused too.
        req = urllib.request.Request(
            f"http://{addr}/recovery/replica", data=body, method="PUT",
            headers={"X-HVD-Signature": rdv_t._signature(
                SECRET, "PUT", "recovery", "replica", b"other")})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 403
        assert rec.store().contribution("opt_state") == []
        with urllib.request.urlopen(f"http://{addr}/healthz",
                                    timeout=5) as r:
            assert r.read() == b"ok"
    finally:
        rec.transport.stop_serving()
