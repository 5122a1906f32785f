"""horovod_tpu_torch's peer recovery tier (``recovery/``) against
horovod_tpu's.

* The arithmetic, value for value: the buddy ring (``buddy_map``,
  ``replica_held``, ``uncovered_ranks``) at worlds 1-16 and strides 0-5,
  the seeded chaos draws, kill epochs and parsed kill/crash specs, and
  the replica wire: ``payload_checksum`` and ``entry_to_bytes`` byte for
  byte on fp32, int64 and bf16 leaves (a bf16 leaf is raw 2-byte words in
  the port; its checksum is the reference's on those words, not on an
  ``ml_dtypes.bfloat16`` array).  The store's two-phase protocol follows
  the reference's on one sequence of puts, seals and deaths.
* Four gloo ranks (``_torch_port_pool.part_results``, bodies in
  ``_torch_port_recovery_workers``), each its own process with its own
  store and ``RecoveryServer`` published in a signed ``RendezvousServer``
  KV, so every buddy copy crosses HTTP.  The small transformer's ZeRO
  stage 1-3 AdamW state after two steps commits (replicate, disk, seal);
  ``peer_restore`` equals ``restore_zero_state`` of the same step bit for
  bit at world 4 and after the ranks re-form worlds of 2 and 3 (one
  rank's memory emptied), and equals the reference's restore of the
  port's disk step at the same worlds.  A buddy-pair loss raises the
  reference's message, a non-adjacent loss does not, an unsealed step
  never restores, a torn copy is counted and excluded, and the
  ``hvd_recovery_*`` families and ``recovery.*`` flight events carry the
  reference's names."""

import dataclasses
import itertools
import os
import sys
import time

import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import horovod_tpu as hvd_jax
from horovod_tpu import checkpoint as ckpt_jax
from horovod_tpu import recovery as rec_jax
from horovod_tpu_torch import recovery as rec
from horovod_tpu_torch.checkpoint import zero as zero_t

import _torch_port_pool as pool
import _torch_port_recovery_workers as W

store_jax = sys.modules["horovod_tpu.recovery.store"]
store_t = sys.modules["horovod_tpu_torch.recovery.store"]
WORLD = pool.WORLD


# ---------------------------------------------------------------------------
# The arithmetic
# ---------------------------------------------------------------------------

def test_package_surface_equals_reference():
    assert rec.__all__ == rec_jax.__all__
    assert [(f.name, f.default) for f in
            dataclasses.fields(rec.RecoveryReport)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(rec_jax.RecoveryReport)]
    assert rec.transport.replica_addr_key(3) == \
        rec_jax.transport.replica_addr_key(3)
    assert rec.transport._KV_MAILBOX_CAP == rec_jax.transport._KV_MAILBOX_CAP


@pytest.mark.parametrize("world", range(1, 17))
def test_buddy_ring_equals_reference(world):
    for stride in range(6):
        assert rec.buddy_map(world, stride) == \
            rec_jax.buddy_map(world, stride)
        for r in range(world):
            assert rec.replica_held(r, world, stride) == \
                rec_jax.replica_held(r, world, stride)
        for n in (1, 2, 3):
            for dead in itertools.combinations(range(world), min(n, world)):
                assert rec.uncovered_ranks(list(dead), world, stride) == \
                    rec_jax.uncovered_ranks(list(dead), world, stride)
    assert rec.replica_holder(0, 1) is None


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_chaos_draws_equal_reference(seed):
    a, b = rec.Chaos(seed=seed), rec_jax.Chaos(seed=seed)
    for i in range(64):
        key = f"slot{i}"
        assert a.kill_epoch(key, 10, 200) == b.kill_epoch(key, 10, 200)
        assert a.draw(key, -5, 5 + i) == b.draw(key, -5, 5 + i)
    assert a.draw("x", 3, 3) == b.draw("x", 3, 3) == 3
    assert a.enabled == b.enabled


@pytest.mark.parametrize("spec", [
    dict(kill_steps="1@7,2@9, bad, 1@12", commit_crash="after_replicate@3",
         torn_ranks="2, 5,x", slow_peer_ms=1.5),
    dict(kill_steps="", commit_crash="pre_manifest", torn_ranks=""),
    dict(kill_steps="0@x,@,3@4", commit_crash="after_replicate@bad"),
])
def test_chaos_specs_parse_as_reference(spec):
    a, b = rec.Chaos(seed=3, **spec), rec_jax.Chaos(seed=3, **spec)
    assert a.kills == b.kills
    assert (a.crash_point, a.crash_step) == (b.crash_point, b.crash_step)
    assert a.torn_ranks == b.torn_ranks
    assert a.slow_peer_ms == b.slow_peer_ms and a.enabled == b.enabled
    for r, s in itertools.product(range(4), range(14)):
        assert a.should_kill(r, s) == b.should_kill(r, s)
        for c, exc in ((a, rec.ChaosKill), (b, rec_jax.ChaosKill)):
            if c.should_kill(r, s):
                with pytest.raises(exc):
                    c.maybe_kill(r, s)
    for point, step in itertools.product(
            ("after_replicate", "pre_manifest", "other"), (None, 2, 3)):
        fired = []
        for c, exc in ((a, rec.ChaosCrash), (b, rec_jax.ChaosCrash)):
            try:
                c.maybe_crash(point, step)
                fired.append(False)
            except exc:
                fired.append(True)
        assert fired[0] == fired[1], (point, step)


def test_chaos_env_parsing_equals_reference(monkeypatch):
    monkeypatch.setenv("HVD_TPU_CHAOS_SEED", "77")
    monkeypatch.setenv("HVD_TPU_CHAOS_KILL_STEPS", "0@5,2@6")
    monkeypatch.setenv("HVD_TPU_CHAOS_COMMIT_CRASH", "pre_manifest@4")
    monkeypatch.setenv("HVD_TPU_CHAOS_SLOW_PEER_MS", "2.5")
    monkeypatch.setenv("HOROVOD_CHAOS_TORN_RANKS", "2,5")
    for mod in (rec, rec_jax):
        mod.reset_chaos()
    a, b = rec.chaos(), rec_jax.chaos()
    assert (a.seed, a.kills, a.crash_point, a.crash_step, a.slow_peer_ms,
            a.torn_ranks, a.enabled) == \
        (b.seed, b.kills, b.crash_point, b.crash_step, b.slow_peer_ms,
         b.torn_ranks, b.enabled) == \
        (77, {0: {5}, 2: {6}}, "pre_manifest", 4, 2.5, {2, 5}, True)
    for knob in ("HVD_TPU_CHAOS_SEED", "HVD_TPU_CHAOS_KILL_STEPS",
                 "HVD_TPU_CHAOS_COMMIT_CRASH", "HVD_TPU_CHAOS_SLOW_PEER_MS",
                 "HOROVOD_CHAOS_TORN_RANKS"):
        monkeypatch.delenv(knob)
    for mod in (rec, rec_jax):
        mod.reset_chaos()
    assert not rec.chaos().enabled and not rec_jax.chaos().enabled


def _arrays(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    if dtype == "int64":
        return {".a": rng.integers(-9, 9, (7,)), ".b": np.asarray(3)}
    if dtype == "float32":
        return {".inner[0].mu['w']": x, ".count": np.asarray(2, np.int32)}
    return {".w": x.astype(ml_dtypes.bfloat16), ".c": np.asarray(1.5)}


def _entry(mod, arrays):
    return mod.ReplicaEntry(
        key="opt_state", rank=2, step=7, world=4, fingerprint="f" * 64,
        manifest_json='{"step": 7}', arrays=arrays,
        checksum=mod.payload_checksum(arrays))


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_checksum_and_wire_form_equal_reference(dtype, monkeypatch):
    ref = _arrays(dtype)
    # The port's host values: a bf16 tensor's raw 2-byte words, as
    # checkpoint.zero.to_host gives them.
    port = {k: zero_t.to_host(torch.from_numpy(
        v.view(np.int16).copy()).view(torch.bfloat16))
        if v.dtype == ml_dtypes.bfloat16 else v for k, v in ref.items()}
    words = {k: v.view("V2") if v.dtype == ml_dtypes.bfloat16 else v
             for k, v in ref.items()}
    for k in ref:
        assert port[k].tobytes() == ref[k].tobytes()
    assert rec.payload_checksum(port) == rec_jax.payload_checksum(words)
    assert (rec.payload_checksum(port) == rec_jax.payload_checksum(ref)) \
        == (dtype != "bfloat16")
    # np.savez stamps the zip members with the clock: hold it still.
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    wire = rec.entry_to_bytes(_entry(rec, port))
    assert wire == rec_jax.entry_to_bytes(_entry(rec_jax, words))
    back = rec_jax.entry_from_bytes(wire)
    assert rec_jax.verify_entry(back) and rec.verify_entry(
        rec.entry_from_bytes(wire))
    # A reference entry holding an ml_dtypes bf16 array decodes as raw
    # words on either side, so its checksum no longer verifies there.
    ref_wire = rec_jax.entry_to_bytes(_entry(rec_jax, ref))
    assert rec.verify_entry(rec.entry_from_bytes(ref_wire)) == \
        rec_jax.verify_entry(rec_jax.entry_from_bytes(ref_wire)) == \
        (dtype != "bfloat16")


def _view(st, key):
    return [(e.rank, e.step, e.sealed, e.checksum)
            for e in st.contribution(key)]


def test_store_protocol_equals_reference(monkeypatch):
    """One sequence of puts, seals, deaths and a torn buddy copy on both
    stores: every contribution, get and byte count agree."""
    monkeypatch.setenv("HVD_TPU_CHAOS_TORN_RANKS", "3")
    for mod in (rec, rec_jax):
        mod.reset_chaos()
    rng = np.random.default_rng(9)
    stores = (store_t.ReplicaStore(), store_jax.ReplicaStore())
    mods = (rec, rec_jax)

    def put(step, world, ranks, own=True, held=True):
        for r in ranks:
            arrays = {".x": rng.standard_normal(4 + r).astype(np.float32)}
            for st, mod in zip(stores, mods):
                e = _entry(mod, dict(arrays))
                e.rank, e.step, e.world = r, step, world
                if own:
                    st.put_own(e)
                if held:
                    st.put_held(mod.ReplicaEntry(**vars(e)))

    def agree():
        a, b = stores
        for key in ("opt_state", "other"):
            assert _view(a, key) == _view(b, key)
            for role in ("own", "held"):
                assert [(e.rank, e.step) for e in a.contribution(key, role)] \
                    == [(e.rank, e.step) for e in b.contribution(key, role)]
            for r in range(6):
                ga, gb = a.get(key, r), b.get(key, r)
                assert (ga is None) == (gb is None)
                if ga is not None:
                    assert (ga.step, ga.checksum) == (gb.step, gb.checksum)
                    assert rec.verify_entry(ga) == rec_jax.verify_entry(gb)
        assert a.total_bytes() == b.total_bytes()
        assert a.keys() == b.keys()

    put(1, 6, range(6))
    agree()
    for st in stores:
        st.seal("opt_state", 2)            # nothing at step 2 yet
    agree()
    for st in stores:
        st.seal("opt_state", 1)
    agree()
    put(2, 4, range(4), held=False)        # a smaller world, unsealed
    agree()
    for st in stores:
        st.seal("opt_state", 2)            # prunes ranks 4 and 5
    agree()
    for st in stores:
        st.simulate_death([1, 2], 4)
    agree()
    for st in stores:
        st.reset_key("opt_state")
    agree()


# ---------------------------------------------------------------------------
# Four ranks, each its own process
# ---------------------------------------------------------------------------

def _prepare(out):
    with open(os.path.join(out, W.SECRET_FILE), "w") as f:
        f.write("recovery-test-secret")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "recovery", prepare=_prepare)


def _survivors(world):
    return W.REFORMED.get(world, tuple(range(WORLD)))


def _restored(ranks, world):
    return [ranks[r][f"restored{world}"] for r in _survivors(world)]


ALL_KEYS = [k for s in W.STAGES for k in W.keys(s)]


@pytest.mark.timeout(240)
def test_buddy_copies_crossed_http(ranks):
    for r in range(WORLD):
        assert ranks[r]["published"].startswith("127.0.0.1:")
        held = rec.replica_held(r, WORLD)
        # The four commits' keys, each holding the buddy's copy only.
        assert {(k, h) for k, h in ranks[r]["held"] if k in ALL_KEYS} == \
            {(k, held) for k in ALL_KEYS}
        for key, c in ranks[r]["committed"].items():
            assert c["replicated"] == c["payload"] > 0, key


@pytest.mark.timeout(240)
@pytest.mark.parametrize("world", [4, 2, 3])
@pytest.mark.parametrize("key", ALL_KEYS)
def test_peer_restore_equals_disk_restore(ranks, world, key):
    for new_rank, got in enumerate(_restored(ranks, world)):
        r = got[key]
        assert r["equal_disk"], (world, key, new_rank)
        assert r["last_report"]
        assert r["devices"] in ([], ["cpu"])
        rep = r["report"]
        assert (rep["path"], rep["step"], rep["world_from"],
                rep["world_to"]) == ("peer", W.STEPS, WORLD, world)
        assert rep["bytes_moved"] == sum(
            ranks[o]["committed"][key]["payload"] for o in range(WORLD))
        assert r["extra"]["run_fingerprint"]["world_size"] == WORLD
        if world == WORLD:
            committed = ranks[new_rank]["committed"][key]["values"]
            assert sorted(committed) == sorted(r["peer"])
            for path, v in committed.items():
                assert torch.equal(v, r["peer"][path]), path


def _tx(stage):
    return hvd_jax.ZeroShardedOptimizer(
        optax.adamw(1e-2, weight_decay=1e-3), stage=stage)


def _logical(state, mesh) -> dict:
    """{leaf path: logical (reassembled, unpadded) value}."""
    ext = ckpt_jax.extract_zero_state(state, mesh=mesh)
    out = {}
    for i, spec in enumerate(ext.specs):
        if spec.kind == ckpt_jax.SHARDED:
            out[spec.path] = np.concatenate(
                [np.asarray(ext.rank_values[r][i]).reshape(-1)
                 for r in range(ext.world)])[:spec.true_size]
        else:
            out[spec.path] = np.asarray(ext.rank_values[0][i])
    return out


@pytest.mark.timeout(240)
@pytest.mark.parametrize("world", [4, 2, 3])
@pytest.mark.parametrize("stage", W.STAGES)
def test_peer_restore_equals_reference_restore(ranks, world, stage):
    """The reference restores the port's disk step of the same commit at
    mesh ``world``: every logical value equals the port's peer-restored
    shards, reassembled, bit for bit."""
    _, params, _, _ = pool.lm_case()
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    tx = _tx(stage)
    likes = {}
    if stage == 3:
        likes[W.keys(3)[1]] = params = ckpt_jax.zero_shard_params(
            tx, params, mesh=mesh)
    likes[W.keys(stage)[0]] = ckpt_jax.zero_init(tx, params, mesh=mesh)
    got = _restored(ranks, world)
    root = os.path.join(pool.part_dir("recovery"), "disk")
    for key, like in likes.items():
        restored = ckpt_jax.restore_zero_state(os.path.join(root, key), like,
                                               mesh=mesh)
        want = _logical(restored, mesh)
        specs = got[0][key]["specs"]
        assert sorted(want) == sorted(specs)
        for path, (kind, true) in specs.items():
            if kind == ckpt_jax.SHARDED:
                port = np.concatenate([g[key]["peer"][path].numpy()
                                       .reshape(-1) for g in got])[:true]
            else:
                port = got[0][key]["peer"][path].numpy()
            assert port.dtype == want[path].dtype, path
            np.testing.assert_array_equal(
                port.reshape(want[path].shape), want[path], err_msg=path)


def _drill(ranks, name):
    return [ranks[r]["drills"][name] for r in range(WORLD)]


@pytest.mark.timeout(240)
def test_unsealed_step_never_restores(ranks):
    for d in _drill(ranks, "unsealed"):
        assert d["newest"] == 1 and d["newest_is_sealed"]
        assert "no replica group covers step 2" in d["pinned"]["error"]
        assert d["after_seal"] == 2 and d["after_seal_is_later"]


@pytest.mark.timeout(240)
def test_torn_copy_is_counted_and_excluded(ranks):
    for d in _drill(ranks, "torn"):
        assert d["owner_alive"]["report"]["path"] == "peer"
        err = d["owner_gone"]["error"]
        assert "missing old-world ranks [1]" in err, err
        assert "1 torn copy excluded" in err, err
        assert d["counted"] == 1


@pytest.mark.timeout(240)
def test_buddy_pair_loss_raises_nonadjacent_does_not(ranks):
    for d in _drill(ranks, "pair"):
        assert d["nonadjacent"]["report"]["path"] == "peer"
        assert "missing old-world ranks [0, 1] (buddy pair lost together)" \
            in d["adjacent"]["error"]


def _reference_names(monkeypatch):
    """The families and flight kinds the reference records for one
    replicate, seal, restore, miss and torn drill (a fresh registry)."""
    import jax.numpy as jnp
    reg_mod = sys.modules["horovod_tpu.metrics.registry"]
    monkeypatch.setattr(reg_mod, "_REGISTRY", reg_mod.MetricsRegistry())
    monkeypatch.setenv("HVD_TPU_CHAOS_TORN_RANKS", "1")
    rec_jax.reset_chaos()
    monkeypatch.setattr(store_jax, "_store", None)
    from horovod_tpu.debug import flight
    seq0 = max([e["seq"] for e in flight.snapshot()], default=-1)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    tx = _tx(1)
    params = {"w": jnp.linspace(-1.0, 1.0, 12).reshape(4, 3)}
    state = ckpt_jax.zero_init(tx, params, mesh=mesh)
    ext = ckpt_jax.extract_zero_state(state, mesh=mesh)
    rec_jax.replicate("k", 0, ext, stride=1)
    rec_jax.seal_commit("k", 0)
    rec_jax.peer_restore("k", state, mesh=mesh)
    rec_jax.store().simulate_death([1], WORLD)
    with pytest.raises(rec_jax.PeerRestoreUnavailable, match="torn"):
        rec_jax.peer_restore("k", state, mesh=mesh)
    rec_jax.reset_chaos()
    fams = {f.name: c for f, c in reg_mod.registry().collect()}
    events = {e["kind"] for e in flight.snapshot() if e["seq"] > seq0
              and e["kind"].startswith("recovery.")}
    paths = sorted(dict(k)["path"]
                   for k, _ in fams["hvd_recovery_restores_total"])
    return sorted(n for n in fams if n.startswith("hvd_recovery_")), \
        paths, sorted(events)


@pytest.mark.timeout(240)
def test_families_and_events_carry_reference_names(ranks, monkeypatch):
    families, paths, events = _reference_names(monkeypatch)
    for r in range(WORLD):
        assert ranks[r]["families"] == families
        assert ranks[r]["restore_paths"] == paths == ["peer", "peer_miss"]
        assert ranks[r]["events"] == events
