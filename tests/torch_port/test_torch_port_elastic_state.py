"""horovod_tpu_torch's ``elastic.TpuState`` against horovod_tpu's.

* Across packages, on the checkpoint tests' problem (ZeRO stage 2 AdamW,
  ``_torch_port_checkpoint_workers``) with a ``DataLoader`` over the
  sample ids: four gloo ranks (``_torch_port_pool.part_results``, part
  "elastic", bodies in ``_torch_port_elastic_workers``) train and commit
  through the port's ``TpuState`` at world 4, and the reference's
  ``TpuState.sync`` restores that step at mesh 2; the reference commits
  at mesh 4 (the test's ``prepare`` hook), and the port's sync restores
  it at world 2.  Every logical value is equal bit for bit, and the
  loaders finish the epoch with no duplicated and no dropped sample
  (reference tests/test_data_pipeline.py:396-500,
  tests/test_checkpoint_engine.py:278-415).
* The recovery drills of the reference's tests/test_recovery.py:329-620
  on those ranks, each its own process with its own replica store: a
  disk-free restart (rank 3's memory gone, the three survivors restore
  from their peers), peer = disk (world 2 from the peers, then from the
  disk after the fleet memory is lost), a buddy pair lost together
  falls back to the disk, the two commit-window crashes restore the
  previous step, and recovery off touches nothing.
* In this process at world 1: the async commit's barrier at the next
  commit and its failures."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd_jax
from horovod_tpu import checkpoint as ckpt_jax
from horovod_tpu.data import ArraySource as ArraySource_jax
from horovod_tpu.data import DataLoader as DataLoader_jax
from horovod_tpu.elastic.state import TpuState as TpuState_jax
from horovod_tpu_torch import checkpoint as ckpt

import _torch_port_checkpoint_workers as CK
import _torch_port_elastic_workers as W
import _torch_port_pool as pool
import test_torch_port_checkpoint as CKT

WORLD = pool.WORLD
_REF = {}


def _ref_loaders(world, seed=3):
    return [DataLoader_jax(ArraySource_jax(np.arange(W.SAMPLES)), W.BATCH,
                           world_size=world, rank=r, shuffle=True, seed=seed,
                           prefetch=False) for r in range(world)]


def _prepare(out):
    """The inputs, and the reference's commit: W.CASE trained W.TAKEN
    steps at mesh 4 with four loaders taking a batch a step, committed by
    its TpuState under ``out/ref``."""
    with open(os.path.join(out, W.SECRET_FILE), "w") as f:
        f.write("elastic-state-test")
    inputs = CKT._inputs()
    np.savez(os.path.join(out, "elastic.npz"), **inputs)
    hvd_jax.init()
    mesh = CKT._mesh(WORLD)
    p, s = CKT._fresh(W.CASE, mesh)
    step = CKT._stepper(W.CASE, mesh, p, s)
    loaders = _ref_loaders(WORLD)
    its = [iter(ld) for ld in loaders]
    taken = []
    for _ in range(W.TAKEN):
        for it in its:
            taken += np.asarray(next(it)).tolist()
        p, s = step(p, s, jnp.asarray(inputs["x"]))
    TpuState_jax(opt_state=s, train_loader=loaders[0],
                 checkpoint_dir=os.path.join(out, "ref"),
                 checkpoint_mesh=mesh).commit()
    for ld in loaders:
        ld.close()
    _REF.update(values=CKT._logical(s, mesh), taken=taken)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "elastic", prepare=_prepare)


def _logical(ranks, key, members=None):
    """{path: logical value} from the members' shards of one result."""
    members = members or [r for r in ranks if key in r]
    results = [r[key] for r in members]
    specs = ranks[0]["port"]["specs"]
    out = {}
    for path, (kind, true_size) in specs.items():
        if kind == ckpt.SHARDED:
            out[path] = np.concatenate(
                [_np(r["values"][path]).reshape(-1)
                 for r in results])[:true_size]
        else:
            out[path] = _np(results[0]["values"][path])
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = _np(a[k]), _np(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x.reshape(-1), y.reshape(-1),
                                      err_msg=k)


def _jax_values(vals: dict) -> dict:
    """The reference's logical values under the port's leaf paths (the
    same strings), counts as the port's int32 host value."""
    return {k: np.asarray(v) for k, v in vals.items()}


def test_port_commit_restores_in_reference_at_mesh_2(ranks):
    mesh2 = CKT._mesh(2)
    root = pool.part_dir("elastic")
    _, fresh = CKT._fresh(W.CASE, mesh2)
    taken = [i for r in ranks for i in r["port"]["taken"]]
    assert len(taken) == WORLD * W.TAKEN * W.BATCH
    loaders = _ref_loaders(2, seed=999)
    restored = None
    for ld in loaders:
        state = TpuState_jax(opt_state=fresh, train_loader=ld,
                             checkpoint_dir=os.path.join(root, "port"),
                             checkpoint_mesh=mesh2, peer_recovery=False)
        state.sync(root=0)
        restored = state.opt_state
        st = ld.state_dict()
        assert (st["cursor"], st["seed"]) == (len(taken), 3)
    _assert_equal(_jax_values(CKT._logical(restored, mesh2)),
                  _logical(ranks, "port"))
    for ld in loaders:
        taken += [i for b in ld for i in np.asarray(b).tolist()]
        ld.close()
    assert sorted(taken) == list(range(W.SAMPLES)), \
        "duplicated or dropped samples"


def test_reference_commit_restores_in_port_at_world_2(ranks):
    got = [r["ref2"] for r in ranks[:2]]
    assert all(g["path"] == "disk" for g in got)
    _assert_equal(_logical(ranks, "ref2", ranks[:2]),
                  _jax_values(_REF["values"]))
    taken = list(_REF["taken"])
    assert all(g["loader"]["cursor"] == len(taken) for g in got)
    taken += [i for g in got for i in g["rest"]]
    assert sorted(taken) == list(range(W.SAMPLES))


def test_disk_free_restart_restores_from_peers(ranks):
    """No checkpoint_dir anywhere: rank 3 dies with its memory, and the
    three survivors restore moments and data position from their peers
    (rank 3's shard from its buddy, rank 0)."""
    got = [r["diskfree3"] for r in ranks[:3]]
    assert all(g["path"] == "peer" and g["step"] == 0 for g in got)
    _assert_equal(_logical(ranks, "diskfree3", ranks[:3]),
                  _logical(ranks, "diskfree"))
    taken = [i for r in ranks for i in r["diskfree"]["taken"]]
    # The rest of the epoch at world 3 is the reference's loaders' from
    # the same committed position (its tail padded by the PAD policy),
    # and no sample is dropped.
    committed = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                 for k, v in ranks[0]["diskfree"]["loader"].items()}
    for r, g in enumerate(got):
        (ld,) = _ref_loaders(3)[r:r + 1]
        ld.load_state_dict(dict(committed))
        assert g["rest"] == [i for b in ld for i in np.asarray(b).tolist()]
        ld.close()
    rest = [i for g in got for i in g["rest"]]
    assert set(taken) | set(rest) == set(range(W.SAMPLES))


def test_peer_and_disk_agree(ranks):
    members = [ranks[0], ranks[2]]
    assert [r["both2_peer"]["path"] for r in members] == ["peer", "peer"]
    assert [r["both2_disk"]["path"] for r in members] == ["disk", "disk"]
    peer = _logical(ranks, "both2_peer", members)
    _assert_equal(peer, _logical(ranks, "both2_disk", members))
    _assert_equal(peer, _logical(ranks, "both"))
    for r in members:
        assert r["both2_peer"]["rest"] == r["both2_disk"]["rest"]


def test_buddy_pair_death_falls_back_to_disk(ranks):
    members = [ranks[0], ranks[3]]
    assert [r["pair2"]["path"] for r in members] == ["disk", "disk"]
    _assert_equal(_logical(ranks, "pair2", members),
                  _logical(ranks, "pair"))


@pytest.mark.parametrize("point", ["after_replicate", "pre_manifest"])
def test_commit_window_crash_restores_previous_step(ranks, point):
    for r in ranks:
        res = r[point]
        assert res["crashed"]
        # The crashed commit is recorded nowhere: step 0 stays the newest.
        assert res["committed"] == {"opt_state": 0}
        assert res["latest"] == 0
        # pre_manifest leaves the torn step's shards, never committed.
        assert res["torn_step_dir"] == (point == "pre_manifest")
        assert (res["path"], res["step"]) == ("peer", 0)
        _assert_equal(res["synced"], res["first"])


def test_recovery_off_touches_nothing(ranks):
    for r in ranks:
        before, after = r["off"]["store_keys"]
        assert before == after == []
    root = os.path.join(pool.part_dir("elastic"), "off", "opt_state")
    assert ckpt.latest_step(root) == 0


# ---------------------------------------------------------------------------
# the async commit, world 1 in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import recovery
    hvd.init(device="cpu")
    recovery.reset_store()
    yield hvd
    recovery.reset_store()
    hvd.shutdown()


def _one_rank_problem(hvd):
    data = CKT._inputs()
    m = CK.model(torch, {n: data[f"param.{n}"] for n in CK.NAMES})
    opt = CK.optimizer(torch, hvd, m, W.CASE)
    x = torch.from_numpy(data["x"][0].copy())
    return m, opt, x


def test_async_commit_overlaps_and_barriers_at_next_commit(
        world1, tmp_path, monkeypatch):
    from horovod_tpu_torch import elastic, recovery
    from horovod_tpu_torch.elastic import state as es
    import horovod_tpu_torch.checkpoint as ck_mod
    m, opt, x = _one_rank_problem(world1)
    state = elastic.TpuState(opt_state=opt, checkpoint_dir=str(tmp_path),
                             async_commit=True)
    gate, started = threading.Event(), threading.Event()
    real = ck_mod.save_extracted

    def slow_save(*a, **k):
        started.set()
        assert gate.wait(timeout=30), "commit barrier deadlock"
        return real(*a, **k)

    monkeypatch.setattr(ck_mod, "save_extracted", slow_save)
    CK.step(m, opt, x)
    state.commit()                 # returns with the flush in flight
    assert started.wait(timeout=30)
    assert state._committer.pending
    entry = recovery.store().get("opt_state", 0)
    assert entry is not None and entry.sealed and entry.step == 0
    assert ckpt.latest_step(os.path.join(str(tmp_path), "opt_state")) \
        is None
    gate.set()
    CK.step(m, opt, x)
    state.commit()                 # barriers on step 0's flush first
    state._committer.wait()
    assert ckpt.latest_step(os.path.join(str(tmp_path), "opt_state")) == 1
    entry = recovery.store().get("opt_state", 0)
    assert entry is not None and entry.sealed and entry.step == 1
    assert es._multi() is False


def test_async_commit_flush_failure_surfaces_at_next_commit(
        world1, tmp_path, monkeypatch):
    from horovod_tpu_torch import elastic, recovery
    import horovod_tpu_torch.checkpoint as ck_mod
    m, opt, x = _one_rank_problem(world1)
    state = elastic.TpuState(opt_state=opt, checkpoint_dir=str(tmp_path),
                             async_commit=True)
    CK.step(m, opt, x)
    state.commit()
    state._committer.wait()
    real = ck_mod.save_extracted

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck_mod, "save_extracted", broken)
    CK.step(m, opt, x)
    state.commit()                 # the flush fails in the background
    with pytest.raises(OSError, match="disk full"):
        state.commit()             # ...and surfaces here
    monkeypatch.setattr(ck_mod, "save_extracted", real)
    # The replica tier sealed step 1 before the disk write failed: the
    # sync restores it from the peers, the disk lagging at step 0.
    state.sync(root=0)
    assert recovery.last_report().path == "peer"
    assert recovery.last_report().step == 1
    assert ckpt.latest_step(os.path.join(str(tmp_path), "opt_state")) == 0


def test_async_pre_seal_failure_unpins_the_ghost_step(
        world1, tmp_path, monkeypatch):
    """A flush that dies BEFORE the replica seal leaves its step in no
    tier: the committed-step record must not pin it, and the sync
    restores the newest real step."""
    from horovod_tpu_torch import elastic, recovery
    m, opt, x = _one_rank_problem(world1)
    state = elastic.TpuState(opt_state=opt, checkpoint_dir=str(tmp_path),
                             async_commit=True)
    CK.step(m, opt, x)
    state.commit()
    state._committer.wait()
    s0 = W._values(ckpt, opt)[0]

    def broken(*a, **k):
        raise OSError("replication failed")

    monkeypatch.setattr(recovery, "replicate", broken)
    CK.step(m, opt, x)
    state.commit()
    with pytest.raises(OSError):
        state._committer.wait()
    state._prune_failed_steps()
    assert state._ckpt_committed_step.get("opt_state", 0) == 0
    monkeypatch.undo()
    state.sync(root=0)
    assert recovery.last_report().step == 0
    _assert_equal(W._values(ckpt, opt)[0], s0)
