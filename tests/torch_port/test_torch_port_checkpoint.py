"""horovod_tpu_torch's sharded checkpoint engine (``checkpoint/``) and
``utils/checkpoint.py`` against horovod_tpu's.

* The engine's protocol, as the reference's tests pin it
  (tests/test_checkpoint_engine.py): a torn step is never latest,
  committed steps are immutable, retention and torn debris, a missing
  shard or leaf key is refused; the shard math equals the reference's.
* Four gloo ranks (``_torch_port_pool.part_results``, bodies in
  ``_torch_port_checkpoint_workers``) and the reference on a 4-device CPU
  mesh train the same problem at ZeRO stages 1, 2, 3 and stage 1 on
  int8, each with AdamW and with SGD with momentum, 2 steps, and
  checkpoint it.  Reference -> port: the port restores the reference's
  step on 4 and on 2 ranks, and every logical moment, count, parameter
  shard and residual equals the reference's array bit for bit.  Port ->
  reference: the reference restores the port's step at mesh 4 and mesh
  2, bit for bit.  The manifests (leaf paths, kinds, dtypes, sizes,
  fingerprint, mesh shape) are equal field for field.  One more step
  from the restored state agrees between the packages within the ZeRO
  parity bar, rtol 1e-5 and atol 1e-6.
* A residual written at world 4 restores at world 2 in neither: the
  port refuses it at restore with ``ValueError``; the reference's
  restore returns it at the writing world's size, which its first
  update at world 2 refuses.
* ``utils.save_checkpoint``'s pickle is read by the reference's
  ``restore_checkpoint`` with Orbax patched out, and the reverse."""

import importlib
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd_jax
from horovod_tpu import checkpoint as ckpt_jax
from horovod_tpu.compat import shard_map
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.utils import checkpoint as utils_ckpt

import _torch_port_checkpoint_workers as W
import _torch_port_pool as pool

# The packages export a function ``reshard`` beside the module.
R = importlib.import_module("horovod_tpu_torch.checkpoint.reshard")
R_jax = importlib.import_module("horovod_tpu.checkpoint.reshard")
WORLD = pool.WORLD
BAR = dict(rtol=1e-5, atol=1e-6)
STEPS = W.STEPS


# ---------------------------------------------------------------------------
# The engine's protocol (single process, numpy)
# ---------------------------------------------------------------------------

def _spec(path=".x", size=2, kind=ckpt.SHARDED):
    return ckpt.LeafSpec(path=path, kind=kind, shape=[size], dtype="float32",
                         true_size=size)


def test_manifest_json_matches_reference():
    spec = _spec(".inner[0].mu['w']", 12)
    m = ckpt.Manifest(step=7, world_size=4, leaves=[spec],
                      extra={"data_iters": {"train": {"cursor": 3}}})
    ref = ckpt_jax.Manifest(step=7, world_size=4,
                            leaves=[ckpt_jax.LeafSpec(**vars(spec))],
                            extra={"data_iters": {"train": {"cursor": 3}}})
    assert m.to_json() == ref.to_json()
    assert ckpt.Manifest.from_json(ref.to_json()) == m
    assert ckpt.shard_filename(3, 4) == ckpt_jax.shard_filename(3, 4)
    assert ckpt.step_dirname(42) == ckpt_jax.step_dirname(42)
    with pytest.raises(ValueError, match="format_version"):
        ckpt.Manifest.from_json(json.dumps({"format_version": 99}))


def test_commit_refuses_missing_shards(tmp_path):
    root = str(tmp_path)
    manifest = ckpt.Manifest(step=3, world_size=2, leaves=[_spec(size=8)])
    ckpt.write_shard(root, 3, 0, 2, {".x": np.zeros(4, np.float32)})
    with pytest.raises(FileNotFoundError, match="missing shard"):
        ckpt.commit(root, 3, manifest)
    assert ckpt.latest_step(root) is None


def test_commit_refuses_shard_missing_leaf_key(tmp_path):
    root = str(tmp_path)
    ckpt.write_shard(root, 1, 0, 1, {".x": np.ones(2, np.float32)})
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.commit(root, 1, ckpt.Manifest(
            step=1, world_size=1, leaves=[_spec(".x"), _spec(".y")]))
    assert ckpt.latest_step(root) is None


def test_torn_step_is_never_latest(tmp_path):
    """Shards written and no manifest, or a manifest whose shard file is
    lost: neither is latest, and neither restores."""
    root = str(tmp_path)
    spec = _spec(size=4)
    for r in range(2):
        ckpt.write_shard(root, 1, r, 2, {".x": np.full(2, r, np.float32)})
    ckpt.commit(root, 1, ckpt.Manifest(step=1, world_size=2, leaves=[spec]))
    for r in range(2):          # crash A: step 2's shards, no manifest
        ckpt.write_shard(root, 2, r, 2, {".x": np.ones(2, np.float32)})
    assert ckpt.latest_step(root) == 1 and not ckpt.is_committed(root, 2)
    ckpt.commit(root, 2, ckpt.Manifest(step=2, world_size=2, leaves=[spec]))
    assert ckpt.latest_step(root) == 2
    os.unlink(os.path.join(root, ckpt.step_dirname(2),
                           ckpt.shard_filename(1, 2)))   # crash B
    assert ckpt.latest_step(root) == 1
    with pytest.raises(FileNotFoundError, match="not a committed"):
        ckpt.restore_leaves(root, 2, 2)
    with pytest.raises(FileNotFoundError, match="not a committed"):
        ckpt.open_step(root, 2, 2)
    # The reference sees the same.
    assert ckpt_jax.latest_step(root) == 1
    step = ckpt.restore_leaves(root, 1, 4)
    np.testing.assert_array_equal(step.full_value(spec), [0, 0, 1, 1])
    assert [step.shard_value(spec, r).tolist() for r in range(4)] == \
        [[0], [0], [1], [1]]


def test_committed_steps_are_immutable(tmp_path):
    root = str(tmp_path)
    ckpt.write_shard(root, 1, 0, 1, {".x": np.ones(2, np.float32)})
    manifest = ckpt.Manifest(step=1, world_size=1, leaves=[_spec()])
    ckpt.commit(root, 1, manifest)
    with pytest.raises(FileExistsError, match="immutable"):
        ckpt.write_shard(root, 1, 0, 1, {".x": np.zeros(2, np.float32)})
    with pytest.raises(FileExistsError, match="immutable"):
        ckpt.commit(root, 1, manifest)
    np.testing.assert_array_equal(ckpt.read_shard(root, 1, 0, 1)[".x"],
                                  np.ones(2, np.float32))


def test_gc_retention_and_torn_debris(tmp_path):
    root = str(tmp_path)
    for step in (1, 2, 3, 4):
        ckpt.write_shard(root, step, 0, 1,
                         {".x": np.full(2, step, np.float32)})
        if step != 3:   # step 3 is torn crash debris
            ckpt.commit(root, step, ckpt.Manifest(step=step, world_size=1,
                                                  leaves=[_spec()]))
    assert ckpt.gc_steps(root, keep=2) == [1, 3]
    assert ckpt.list_steps(root) == [2, 4]
    np.testing.assert_array_equal(ckpt.read_shard(root, 4, 0, 1)[".x"],
                                  np.full(2, 4, np.float32))


@pytest.mark.parametrize("true_size,old,new", [
    (10, (4,), (2,)), (7, (2,), (3,)), (13, (2, 2), (4,)),
    (9, (2, 2, 2), (2, 2, 1)), (1, (3,), (1,))])
def test_shard_math_matches_reference(true_size, old, new):
    x = np.arange(true_size, dtype=np.float32) + 0.5
    n = int(np.prod(old))
    assert np.array_equal(R.pad_flat(x, n), R_jax.pad_flat(x, n))
    shards = [R.mesh_shard_of(x, old, *rk) for rk in np.ndindex(*old)]
    for a, rk in zip(shards, np.ndindex(*old)):
        assert np.array_equal(a, R_jax.mesh_shard_of(x, old, *rk))
    if len(old) == 1:
        assert all(np.array_equal(R.shard_of(x, n, r), s)
                   for r, s in enumerate(shards))
        assert all(np.array_equal(a, b) for a, b in zip(
            R.reshard(shards, true_size, 5),
            R_jax.reshard(shards, true_size, 5)))
    moved = R.reshard_mesh(shards, true_size, old, new)
    assert all(np.array_equal(a, b) for a, b in zip(
        moved, R_jax.reshard_mesh(shards, true_size, old, new)))
    assert np.array_equal(R.reassemble_mesh(moved, true_size, new), x)


def test_data_state_standalone_step(tmp_path):
    root = str(tmp_path)
    state = {"train": {"epoch": 1, "cursor": 24}}
    ckpt.save_data_state(root, state, step=5, keep=1)
    assert ckpt.restore_data_state(root) == state
    assert ckpt_jax.restore_data_state(root) == state
    with pytest.raises(ValueError, match="JSON-serializable"):
        ckpt.save_data_state(root, {"x": object()}, step=6)


# ---------------------------------------------------------------------------
# The reference's side of the four-rank drills
# ---------------------------------------------------------------------------

_REF = {}


def _inputs():
    return pool.part_inputs("ckpt")


def _tree(flat):
    """{"w", "b", "layers.u", "layers.a"} -> the reference's nested dict."""
    out = {}
    for name, v in flat.items():
        *outer, leaf = name.split(".")
        d = out
        for k in outer:
            d = d.setdefault(k, {})
        d[leaf] = jnp.asarray(v)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_loss(p, x):
    s = x.sum() * 0.1
    return (jnp.sum((x @ p["w"]) ** 2) * 1e-3
            + jnp.sum((p["b"] * s) ** 2) * 1e-3
            + jnp.sum((p["layers"]["u"] * x[:, :3]) ** 2) * 1e-2
            + jnp.sum(jnp.sin(p["layers"]["a"]) * s) * 1e-2)


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _tx(case):
    stage, inner, wire = W.CASES[case]
    opt = optax.adamw(1e-2, weight_decay=1e-3) if inner == "adamw" else \
        optax.sgd(0.1, momentum=0.9)
    return hvd_jax.ZeroShardedOptimizer(
        opt, stage=stage,
        compression=hvd_jax.Compression.int8 if wire else None)


def _initial():
    return _tree({n: _inputs()[f"param.{n}"] for n in W.NAMES})


def _fresh(case, mesh):
    """(params or stage-3 param state, optimizer state) from the initial
    parameters, globally threaded on ``mesh``."""
    tx = _tx(case)
    p0 = _initial()
    if W.CASES[case][0] == 3:
        p0 = ckpt_jax.zero_shard_params(tx, p0, mesh=mesh)
    return p0, ckpt_jax.zero_init(tx, p0, mesh=mesh)


def _stepper(case, mesh, p, s):
    """One reference step on ``mesh``, each rank its row of x."""
    tx = _tx(case)
    stage = W.CASES[case][0]
    p0 = _initial()
    p_spec = ckpt_jax.zero_state_specs(p) if stage == 3 else P()
    s_spec = ckpt_jax.zero_state_specs(s)

    def step(p, s, x):
        x = x[0]
        if stage == 3:
            g = jax.grad(lambda sh: _jax_loss(tx.gather_params(sh, p0), x))(
                p.inner)
        else:
            g = jax.grad(_jax_loss)(p, x)
            if stage == 2:
                g = tx.reduce_grads(g)
        u, s = tx.update(g, s, p)
        return (tx.apply_updates(p, u) if stage == 3
                else optax.apply_updates(p, u)), s
    return jax.jit(shard_map(step, mesh=mesh, in_specs=(p_spec, s_spec,
                                                        P("data")),
                             out_specs=(p_spec, s_spec), check_vma=False))


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


def _full_params(case, p, mesh) -> dict:
    if W.CASES[case][0] < 3:
        return _flat(p)
    vals = _logical(p, mesh)
    return {n: vals[_path(".inner", n)].reshape(_inputs()[f"param.{n}"]
                                                .shape) for n in W.NAMES}


def _path(prefix, name):
    return prefix + "".join(f"[{k!r}]" for k in name.split("."))


def _prepare(out):
    """Train each case for STEPS steps at world 4, write its step under
    ``out/ref/<case>`` (and the replicated parameters for the ranks), and
    take one more step."""
    inputs = _inputs()
    hvd_jax.init()
    mesh = _mesh(WORLD)
    x = jnp.asarray(inputs["x"])
    arrays = dict(inputs)
    for case in W.CASES:
        p, s = _fresh(case, mesh)
        step = _stepper(case, mesh, p, s)
        for _ in range(STEPS):
            p, s = step(p, s, x)
        root = os.path.join(out, "ref", case)
        ckpt_jax.save_zero_state(os.path.join(root, "opt"), s, step=STEPS,
                                 mesh=mesh)
        if W.CASES[case][0] == 3:
            ckpt_jax.save_zero_state(os.path.join(root, "params"), p,
                                     step=STEPS, mesh=mesh)
        else:
            arrays.update({f"ref{STEPS}.{case}.{n}": v
                           for n, v in _flat(p).items()})
        p, s = step(p, s, x)
        _REF[case] = _full_params(case, p, mesh)
    np.savez(os.path.join(out, "ckpt.npz"), **arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "ckpt", prepare=_prepare)


def _ref_shards(root, path, world=WORLD):
    d = os.path.join(root, ckpt.step_dirname(STEPS))
    return [np.load(os.path.join(d, ckpt.shard_filename(r, world)))[path]
            for r in range(world)]


def _by_path(dump):
    """A rank's dump keyed by the reference's leaf paths."""
    out = {}
    for (field, name), v in dump.items():
        if field == "count":
            out[".inner[0].count"] = v
        elif field == "param":
            out[_path(".inner", name)] = v
        elif field == "residual":
            out[_path(".residual", name)] = v
        else:
            out[_path(f".inner[0].{field}", name)] = v
    return out


def _roots(case, who):
    base = os.path.join(pool.part_dir("ckpt"), who, case)
    roots = [("opt", os.path.join(base, "opt"))]
    if W.CASES[case][0] == 3:
        roots.append(("params", os.path.join(base, "params")))
    return roots


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("world", [4, 2])
def test_reference_checkpoint_restores_in_port(ranks, case, world):
    """Every leaf of the reference's step, resharded for the port's world
    by the reference's own shard math, equals what the port's ranks hold
    after load_state_dict, bit for bit."""
    entries = [ranks[r][f"{case}-restored{world}"] for r in range(world)]
    if W.CASES[case][2] is not None and world != WORLD:
        for msg in entries:
            assert "error-feedback residuals" in msg and "world 4" in msg
        return
    got = [_by_path(e) for e in entries]
    checked = 0
    for _, root in _roots(case, "ref"):
        manifest = ckpt_jax.read_manifest(root, STEPS)
        for spec in manifest.leaves:
            shards = _ref_shards(root, spec.key)
            if spec.path.startswith(".sizes"):
                continue      # checked against the parameters on restore
            if spec.kind == ckpt_jax.REPLICATED:   # the count
                for r in range(world):
                    assert got[r][spec.path] == float(shards[0])
            else:
                want = R_jax.reshard(shards, spec.true_size, world)
                for r in range(world):
                    np.testing.assert_array_equal(
                        got[r][spec.path].numpy(), want[r], err_msg=spec.path)
            checked += 1
    assert checked == sum(len(g) for g in got[:1])


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", list(W.CASES))
def test_port_checkpoint_restores_in_reference(ranks, case):
    """The reference restores the port's step at mesh 4 and mesh 2; every
    logical value equals the port's ranks' shards, reassembled, bit for
    bit.  A residual at mesh 2 comes back at the writing world's size,
    and the reference's first update at world 2 refuses it."""
    saved = [_by_path(ranks[r][f"{case}-saved"]) for r in range(WORLD)]
    sizes = {n: _inputs()[f"param.{n}"].size for n in W.NAMES}
    stage, _, wire = W.CASES[case]

    def port_value(path):
        return np.concatenate([s[path].numpy() for s in saved])

    for world in (4, 2):
        mesh = _mesh(world)
        fresh = _fresh(case, mesh)
        likes = (fresh[1], fresh[0]) if stage == 3 else (fresh[1],)
        for (which, root), like in zip(_roots(case, "port"), likes):
            restored = ckpt_jax.restore_zero_state(root, like, mesh=mesh)
            if wire is not None and world != WORLD:
                # Back at the writing world's global size, 4 x true ...
                for n, v in _flat(restored.residual).items():
                    np.testing.assert_array_equal(
                        v, port_value(_path(".residual", n)))
                    assert v.size == WORLD * sizes[n]
                # ... which the reference's first update refuses.
                step = _stepper(case, mesh, restored, restored)
                with pytest.raises(TypeError, match="reshape"):
                    jax.eval_shape(lambda s: step(_initial(), s, jnp.asarray(
                        _inputs()["x"][:world])), restored)
                restored = restored._replace(residual=like.residual)
            for path, v in _logical(restored, mesh).items():
                name = _name(path)
                if path.startswith(".sizes"):
                    assert int(v) == sizes[name]
                elif path == ".inner[0].count":
                    assert int(v) == saved[0][path] == STEPS
                elif path.startswith(".residual"):
                    if world != WORLD:
                        continue      # held above
                    np.testing.assert_array_equal(v, port_value(path))
                    assert v.size == WORLD * sizes[name]
                else:
                    np.testing.assert_array_equal(
                        v, port_value(path)[:sizes[name]], err_msg=path)
                    assert v.size == sizes[name]


def _name(path):
    """The parameter name of a leaf path: ``.inner[0].mu['layers']['a']``
    -> ``layers.a``."""
    return ".".join(re.findall(r"\['([^']*)'\]", path))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", list(W.CASES))
def test_manifests_equal_field_for_field(ranks, case):
    for (which, port_root), (_, ref_root) in zip(_roots(case, "port"),
                                                 _roots(case, "ref")):
        port = ckpt_jax.read_manifest(port_root, STEPS)
        ref = ckpt_jax.read_manifest(ref_root, STEPS)
        assert port.to_json() == ref.to_json(), which
        fp = port.extra["run_fingerprint"]
        assert fp == {"leaf_spec_sha256":
                      ckpt_jax.manifest.spec_fingerprint(ref.leaves),
                      "mesh_shape": {"data": WORLD}, "world_size": WORLD}
        assert sorted(os.listdir(os.path.join(
            port_root, ckpt.step_dirname(STEPS)))) == sorted(os.listdir(
                os.path.join(ref_root, ckpt.step_dirname(STEPS))))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", list(W.CASES))
def test_one_more_step_agrees(ranks, case):
    """From the reference's restored step, one more port step on 4 ranks
    equals one more reference step within the ZeRO parity bar; every rank
    holds the same parameters."""
    for r in range(WORLD):
        got = ranks[r][f"{case}-next4"]
        assert sorted(got) == sorted(W.NAMES)
        for n in W.NAMES:
            np.testing.assert_allclose(got[n].numpy(), _REF[case][n], **BAR,
                                       err_msg=n)
            assert torch.equal(got[n], ranks[0][f"{case}-next4"][n])


@pytest.mark.timeout(240)
def test_one_more_step_agrees_after_reshard(ranks):
    """The stage-3 step (parameters and moments) restored at world 2 in
    both packages steps on alike."""
    case = W.NEXT2
    mesh = _mesh(2)
    fresh = _fresh(case, mesh)
    root = dict(_roots(case, "ref"))
    p = ckpt_jax.restore_zero_state(root["params"], fresh[0], mesh=mesh)
    s = ckpt_jax.restore_zero_state(root["opt"], fresh[1], mesh=mesh)
    p, _ = _stepper(case, mesh, p, s)(p, s, jnp.asarray(
        _inputs()["x"][:2]))
    want = _full_params(case, p, mesh)
    for r in range(2):
        got = ranks[r][f"{case}-next2"]
        for n in W.NAMES:
            np.testing.assert_allclose(got[n].numpy(), want[n], **BAR,
                                       err_msg=n)


# ---------------------------------------------------------------------------
# utils.checkpoint: the replicated form
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_replicated_pickle_crosses_packages(tmp_path, monkeypatch, world1):
    """The port's rank-0 pickle is read by the reference's
    restore_checkpoint with Orbax patched out, and the reverse; a target
    gets the values in place."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    from horovod_tpu.utils import checkpoint as utils_jax
    assert utils_jax._orbax() is None
    m = W.model(torch, {n: _inputs()[f"param.{n}"] for n in W.NAMES})
    path = str(tmp_path / "params")
    utils_ckpt.save_checkpoint(path, m.state_dict(), step=3)
    assert utils_ckpt.latest_step(str(tmp_path), "params") == 3
    back = utils_jax.restore_checkpoint(path, step=3)
    for name, t in m.state_dict().items():
        np.testing.assert_array_equal(back[name], t.numpy())
    utils_ckpt.save_checkpoint(path, m.state_dict(), step=4, rank=1)
    assert not os.path.exists(path + "-4.pkl")    # rank 1 writes nothing

    ref = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
           "nested": {"b": np.ones(4, np.float32)}}
    utils_jax.save_checkpoint(str(tmp_path / "ref"), ref, rank=0)
    target = {"w": torch.zeros(2, 3), "nested": {"b": torch.zeros(4)}}
    w = target["w"]
    out = utils_ckpt.restore_checkpoint(str(tmp_path / "ref"), target=target)
    assert out["w"] is w and torch.equal(w, torch.from_numpy(ref["w"]))
    assert torch.equal(out["nested"]["b"], torch.ones(4))
    plain = utils_ckpt.restore_checkpoint(str(tmp_path / "ref"))
    np.testing.assert_array_equal(plain["w"], ref["w"])


def test_utils_delegates_zero_state_and_refuses_orbax(tmp_path, world1):
    """A state holding a ZeroShardedOptimizer goes to the engine (plain
    tensors beside it ride along, replicated); engine roots and Orbax
    directories are refused without a target."""
    m = W.model(torch, {n: _inputs()[f"param.{n}"] for n in W.NAMES})
    opt = W.optimizer(torch, hvd, m, "s1-adamw")
    x = torch.from_numpy(_inputs()["x"][0].copy())
    W.step(m, opt, x)
    root = str(tmp_path / "run")
    utils_ckpt.save_checkpoint(root, {"opt": opt, "w": m.w})   # step 0
    utils_ckpt.save_checkpoint(root, {"opt": opt, "w": m.w})   # step 1
    assert ckpt.list_steps(root) == [0, 1]
    paths = [l.path for l in ckpt.read_manifest(root, 1).leaves]
    assert paths[0] == "['opt'].sizes['b']" and paths[-1] == "['w']"
    m2 = W.model(torch, {n: 0 * _inputs()[f"param.{n}"] for n in W.NAMES})
    opt2 = W.optimizer(torch, hvd, m2, "s1-adamw")
    out = utils_ckpt.restore_checkpoint(root, target={"opt": opt2,
                                                      "w": m2.w})
    assert out["opt"] is opt2 and torch.equal(m2.w, m.w)
    for a, b in zip(W.dump(opt).values(), W.dump(opt2).values()):
        assert a == b if isinstance(a, float) else torch.equal(a, b)
    with pytest.raises(ValueError, match="sharded engine checkpoint"):
        utils_ckpt.restore_checkpoint(root)
    os.makedirs(tmp_path / "orbax-7")
    with pytest.raises(ValueError, match=r"<path>\[-<step>\]\.pkl"):
        utils_ckpt.restore_checkpoint(str(tmp_path / "orbax"), step=7)


def test_zero_checkpoint_refusals(tmp_path, world1):
    """A foreign run's directory, an unmapped inner optimizer, and torch's
    dict idiom are refused."""
    m = W.model(torch, {n: _inputs()[f"param.{n}"] for n in W.NAMES})
    adamw = W.optimizer(torch, hvd, m, "s1-adamw")
    sgdm = W.optimizer(torch, hvd, m, "s1-sgdm")
    root = str(tmp_path / "opt")
    adamw.state_dict(root, step=1)
    with pytest.raises(ValueError, match="different run"):
        sgdm.state_dict(root, step=2)
    with pytest.raises(ValueError, match="different run"):
        sgdm.load_state_dict(root)
    with pytest.raises(TypeError, match="sharded checkpoint engine"):
        adamw.state_dict()
    with pytest.raises(TypeError, match="sharded checkpoint engine"):
        adamw.load_state_dict({})
    rms = hvd.ZeroShardedOptimizer(m, torch.optim.RMSprop)
    with pytest.raises(ValueError, match="Adam, torch.optim.AdamW and"):
        rms.state_dict(str(tmp_path / "rms"), step=1)


def _states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k] == b[k] if isinstance(a[k], float) else torch.equal(a[k], b[k])
        for k in a)


def test_stage3_pair_commits_with_the_optimizer_root(tmp_path, world1):
    """At stage 3 the optimizer root's manifest commits the pair with the
    parameter root: a save that died after its parameter step is not
    restored, a step missing from either root is refused before any
    tensor changes, the newest step committed under both is the one
    restored, and the next save of the step replaces the orphaned
    parameters."""
    m = W.model(torch, {n: _inputs()[f"param.{n}"] for n in W.NAMES})
    opt = W.optimizer(torch, hvd, m, "s3-adamw")
    x = torch.from_numpy(_inputs()["x"][0].copy())
    root = str(tmp_path / "opt")
    proot = root + "-params"
    W.step(m, opt, x)
    opt.state_dict(root, step=1)
    at1 = W.dump(opt)
    W.step(m, opt, x)
    opt.state_dict(root, step=2)
    at2 = W.dump(opt)
    assert ckpt.list_steps(root) == ckpt.list_steps(proot) == [1, 2]
    # Torn after the parameters (the order state_dict writes in), then
    # torn the other way round; only the first can be saved over.
    for torn, whole in ((root, proot), (proot, root)):
        os.remove(os.path.join(ckpt.step_dir(torn, 2), ckpt.MANIFEST_NAME))
        assert ckpt.list_steps(torn) == [1] and \
            ckpt.list_steps(whole) == [1, 2]
        W.step(m, opt, x)
        before = W.dump(opt)
        with pytest.raises(FileNotFoundError, match="not committed"):
            opt.load_state_dict(root, step=2)
        assert _states_equal(W.dump(opt), before)
        assert opt.load_state_dict(root).step == 1
        assert _states_equal(W.dump(opt), at1)
        W.step(m, opt, x)
        if torn == root:
            opt.state_dict(root, step=2)     # replaces the orphan
            assert ckpt.list_steps(root) == ckpt.list_steps(proot) == [1, 2]
            assert _states_equal(W.dump(opt), at2)
            opt.load_state_dict(root)
            assert _states_equal(W.dump(opt), at2)
    opt.state_dict(root, step=3, keep=1)
    assert ckpt.list_steps(root) == ckpt.list_steps(proot) == [3]


def test_bf16_leaf_crosses_packages(tmp_path, monkeypatch, world1):
    """A bf16 leaf is stamped "bfloat16" and stored as its raw 2-byte
    words, as the reference stores one: the manifests and fingerprints are
    equal, each package restores the other's bits, and the replicated
    pickle carries the same bits both ways."""
    import ml_dtypes
    bits = np.asarray([0x3FC0, 0xC010, 0x4040, 0x0001, 0xFF80], np.uint16)
    e = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    f = torch.linspace(-1.0, 1.0, 3)
    like = {"e": jnp.asarray(bits.view(ml_dtypes.bfloat16)),
            "f": jnp.asarray(f.numpy())}
    port_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save_zero_state(port_root, {"e": e, "f": f}, 0)
    ckpt_jax.save_zero_state(ref_root, like, 0, mesh=_mesh(1),
                             axis_name="data")
    port = ckpt_jax.read_manifest(port_root, 0)
    ref = ckpt_jax.read_manifest(ref_root, 0)
    assert port.to_json() == ref.to_json()
    assert [l.dtype for l in port.leaves] == ["bfloat16", "float32"]
    shard = ckpt.shard_filename(0, 1)
    for key in ("['e']", "['f']"):
        a, b = (np.load(os.path.join(r, ckpt.step_dirname(0), shard))[key]
                for r in (port_root, ref_root))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    back = ckpt_jax.restore_zero_state(port_root, like, mesh=_mesh(1),
                                       axis_name="data")
    np.testing.assert_array_equal(np.asarray(back["e"]).view(np.uint16),
                                  bits)
    target = {"e": torch.zeros(5, dtype=torch.bfloat16), "f": torch.zeros(3)}
    out = ckpt.restore_zero_state(ref_root, target)
    assert out["e"] is target["e"] and torch.equal(out["f"], f)
    np.testing.assert_array_equal(
        target["e"].view(torch.int16).numpy().view(np.uint16), bits)

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    from horovod_tpu.utils import checkpoint as utils_jax
    utils_ckpt.save_checkpoint(str(tmp_path / "p"), {"e": e}, step=0)
    stored = utils_jax.restore_checkpoint(str(tmp_path / "p"), step=0)["e"]
    np.testing.assert_array_equal(np.asarray(stored).view(np.uint16), bits)
    utils_jax.save_checkpoint(str(tmp_path / "r"),
                              {"e": np.asarray(like["e"])}, rank=0)
    target = {"e": torch.zeros(5, dtype=torch.bfloat16)}
    utils_ckpt.restore_checkpoint(str(tmp_path / "r"), target=target)
    np.testing.assert_array_equal(
        target["e"].view(torch.int16).numpy().view(np.uint16), bits)


def test_pickle_restore_checks_shapes(tmp_path, world1):
    """A stored array is copied only into a tensor of its own shape, and a
    list only into a list of its own length."""
    path = str(tmp_path / "p")
    utils_ckpt.save_checkpoint(path, {"w": torch.arange(12.0).reshape(4, 3),
                                      "l": [torch.ones(2), torch.ones(2)]})
    for target in ({"w": torch.zeros(3, 4), "l": [torch.zeros(2)] * 2},
                   {"w": torch.zeros(12), "l": [torch.zeros(2)] * 2}):
        with pytest.raises(ValueError, match=r"\['w'\].*does not fit"):
            utils_ckpt.restore_checkpoint(path, target=target)
    with pytest.raises(ValueError, match=r"\['l'\]: 2 stored values for 1"):
        utils_ckpt.restore_checkpoint(path, target={
            "w": torch.zeros(4, 3), "l": [torch.zeros(2)]})
