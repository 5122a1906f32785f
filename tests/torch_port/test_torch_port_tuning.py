"""horovod_tpu_torch's tuning memory (``fleet/tuning.py``) and the tuner's
closed loop over it against horovod_tpu's.

A record one package stores must be found by the other for the same
model, world and topology: the model fingerprint of the port's flagship
(its parameters from ``convert.params_from_jax``, as a state dict or a
module, beside its optimizer state) equals the reference's fingerprint
of the JAX parameters; keys and topology signatures are equal; either
package's ``LocalTuningStore`` reads the other's file; a record of the
wrong schema or knob space is refused alike.  ``announce_model``
warm-starts a port tuner from a reference-stored record with no
exploration, and ``warm_start`` is bit-equal between the packages."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.autotune as ref_at
import horovod_tpu.fleet.tuning as ref_T
from horovod_tpu.models import transformer as tfm_jax
from horovod_tpu.ops import dispatch as ref_dispatch
import horovod_tpu_torch.autotune as at
import horovod_tpu_torch.fleet.tuning as T
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import dispatch

SMALL = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=64)


def _jax_params(dtype=jnp.float32, seed=0):
    cfg = tfm_jax.TransformerConfig(dtype=dtype, **SMALL)
    return tfm_jax.init_params(jax.random.PRNGKey(seed), cfg,
                               tfm_jax.ParallelConfig())


@pytest.fixture(autouse=True)
def _no_loop():
    yield
    at.set_active_manager(None)
    ref_at.set_active_manager(None)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_fingerprint_equals_reference(dtype):
    """The flagship's parameters (fp32 in both packages, whatever the
    compute dtype) as the reference's pytree, the port's state dict and
    the port's module holding it."""
    params = _jax_params(getattr(jnp, dtype))
    ref = ref_T.model_fingerprint({"params": params})
    state = convert.params_from_jax(params)
    assert T.model_fingerprint({"params": state}) == ref
    model = tfm.Transformer(tfm.TransformerConfig(
        dtype=getattr(torch, dtype), remat=False, **SMALL), device="cpu")
    model.load_state_dict(state)
    assert T.model_fingerprint({"params": model}) == ref
    # A different model is a different key.
    params2 = dict(params, pos=np.zeros((SMALL["seq_len"] * 2,
                                         SMALL["d_model"]), np.float32))
    assert ref_T.model_fingerprint({"params": params2}) != ref


def test_fingerprint_walks_optimizer_state_and_containers():
    """Nested containers flatten as ``jax.tree_util`` does (dict keys
    sorted, lists by index, named tuples by field); an optimizer is its
    ``state_dict()``."""
    tree = {"b": [np.zeros((2,), np.float32), 3], "a": {"y": 1.5,
                                                       "x": np.ones(4)}}
    assert T.model_fingerprint(tree) == ref_T.model_fingerprint(tree)
    w = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.SGD([w], lr=0.1)
    assert T.model_fingerprint({"opt": opt}) == \
        T.model_fingerprint({"opt": opt.state_dict()})
    assert T.model_fingerprint({"w": np.zeros((4, 4), np.float32)}) != \
        T.model_fingerprint({"w": np.zeros((4, 8), np.float32)})


@pytest.mark.parametrize("world,topo", [(1, "flat"), (4, "l2"),
                                        (8, "l4.tabcdef012345")])
def test_config_key_equals_reference(world, topo):
    assert T.config_key("fp", world, topo) == ref_T.config_key(
        "fp", world, topo)


@pytest.mark.parametrize("local", [None, "2"])
def test_topology_signature_equals_reference(local, monkeypatch):
    if local:
        monkeypatch.setenv("HVD_TPU_LOCAL_SIZE", local)
    try:
        assert T.topology_signature() == ref_T.topology_signature()
        kinds = {"allreduce": True, "allgather": False, "broadcast": False}
        dispatch.set_active(dispatch.constant_table(
            {k: kinds.get(k, False) for k in dispatch.KINDS},
            source="probe"))
        ref_dispatch.set_active(ref_dispatch.constant_table(
            {k: kinds.get(k, False) for k in ref_dispatch.KINDS},
            source="probe"))
        assert T.topology_signature() == ref_T.topology_signature()
        assert ".t" in T.topology_signature() or \
            T.topology_signature().startswith("t")
    finally:
        dispatch.reset()
        ref_dispatch.reset()


# ---------------------------------------------------------------------------
# records and stores
# ---------------------------------------------------------------------------

DIMS = at.ParameterManager(lambda *a: None, attribution_source=lambda: None
                           ).gp_dims()
CONFIG = {"fusion_bytes": 1 << 25, "cycle_ms": 2.5,
          "hierarchical_allreduce": False, "hierarchical_allgather": False,
          "cache_enabled": True, "compression": "bf16",
          "overlap_bucket_bytes": 0}


def test_make_record_equals_reference(monkeypatch):
    monkeypatch.setattr(T.time, "time", lambda: 12.5)
    monkeypatch.setattr(ref_T.time, "time", lambda: 12.5)
    assert T.make_record(CONFIG, 3e9, DIMS) == \
        ref_T.make_record(CONFIG, 3e9, DIMS)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_local_store_crosses_packages(writer, reader, tmp_path):
    mods = {"port": T, "ref": ref_T}
    w, r = mods[writer], mods[reader]
    w.LocalTuningStore(str(tmp_path)).put(
        "k1", w.make_record(CONFIG, 1e9, DIMS))
    store = r.LocalTuningStore(str(tmp_path))
    rec = store.get("k1", dims=DIMS)
    assert rec["config"] == CONFIG and rec["score"] == 1e9
    assert store.keys() == ["k1"] and store.get("missing") is None
    # The reader appends to the writer's file; the writer sees both.
    store.put("k2", r.make_record(CONFIG, None, DIMS))
    assert w.LocalTuningStore(str(tmp_path)).keys() == ["k1", "k2"]


@pytest.mark.parametrize("bad", ["schema", "dims", "not_a_record"])
def test_mismatches_refused_alike(bad, tmp_path):
    rec = T.make_record(CONFIG, 1.0, DIMS)
    if bad == "schema":
        rec["schema"] = 99
    elif bad == "dims":
        rec["dims"] = list(DIMS[:5])
    else:
        rec = ["nope"]
    path = tmp_path / "tuned_configs.json"
    path.write_text(json.dumps({"version": 1, "configs": {"k": rec}}))
    outcomes = []
    for mod in (T, ref_T):
        with pytest.raises(mod.TuningSchemaMismatch):
            mod.check_record(rec, DIMS)
        try:
            mod.LocalTuningStore(str(tmp_path)).get("k", dims=DIMS)
            outcomes.append("read")
        except mod.TuningSchemaMismatch:
            outcomes.append("refused")
    assert outcomes == ["refused", "refused"]


def test_resolve_store_as_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MEMORY_DIR", str(tmp_path))
    got, ref = T.resolve_store(), ref_T.resolve_store()
    assert type(got).__name__ == type(ref).__name__ == "LocalTuningStore"
    assert got._path == ref._path
    monkeypatch.setenv("HVD_TPU_FLEET_ADDR", "127.0.0.1:9")
    got, ref = T.resolve_store(), ref_T.resolve_store()
    assert type(got).__name__ == "GatewayTuningStore" and got.addr == ref.addr


# ---------------------------------------------------------------------------
# the closed loop over the memory
# ---------------------------------------------------------------------------

def _pm(mod, out, **kw):
    return mod.ParameterManager(lambda *a, out=out: out.append(a),
                                max_samples=4, warmup_samples=0,
                                attribution_source=lambda: None, **kw)


@pytest.mark.parametrize("kw", [{}, {"tune_toggles": (False, False, True)},
                                {"tune_compression": True}])
def test_warm_start_bit_equal(kw):
    rec = T.make_record(CONFIG, 2e9, _pm(at, [], **kw).gp_dims())
    runs = []
    for mod in (at, ref_at):
        applied = []
        pm = _pm(mod, applied, **kw)
        assert pm.warm_start(dict(rec))
        while not pm.frozen:
            pm._observe(1e9 + 1e6 * len(applied))
        runs.append((applied, pm.journal(), pm.loop_status()))
    assert runs[0] == runs[1]
    assert runs[0][2]["warm_started"]


def test_warm_start_refused_on_dims_and_after_tuning_started():
    pm = _pm(at, [])
    with pytest.raises(ValueError, match="knob space"):
        pm.warm_start({"dims": ["x"], "config": CONFIG})
    pm._observe(1.0)
    assert pm.warm_start(T.make_record(CONFIG, 1.0, pm.gp_dims())) is False


def test_announce_model_warm_starts_from_a_reference_record(
        tmp_path, monkeypatch):
    """A reference job froze over the JAX parameters and stored its best;
    the port's job announcing the same model (its module) at the same
    world and topology starts from it with no exploration."""
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MEMORY_DIR", str(tmp_path))
    params = _jax_params()
    ref_pm = _pm(ref_at, [])
    ref_at.set_active_manager(ref_pm)
    key = ref_at.announce_model({"params": params}, world=2)
    while not ref_pm.frozen:
        ref_pm._observe(1e9 + 7.0 * ref_pm.current[1])
    ref_at.set_active_manager(None)
    assert ref_T.LocalTuningStore(str(tmp_path)).keys() == [key]
    stored = ref_T.LocalTuningStore(str(tmp_path)).get(key)

    model = tfm.Transformer(tfm.TransformerConfig(
        dtype=torch.float32, remat=False, **SMALL), device="cpu")
    model.load_state_dict(convert.params_from_jax(params))
    applied = []
    pm = _pm(at, applied)
    at.set_active_manager(pm)
    assert at.announce_model({"params": model}, world=2) == key
    st = pm.loop_status()
    assert st["warm_started"] and pm._toggle_plan == []
    want = pm._config_from_dict(stored["config"])
    assert applied[-1] == want and pm.current == want
    # Frozen after max_samples, written back under the same key.
    while not pm.frozen:
        pm._observe(2e9)
    assert T.LocalTuningStore(str(tmp_path)).get(key)["score"] == 2e9


def test_announce_model_refuses_stale_dims_and_trains_cold(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MEMORY_DIR", str(tmp_path))
    pm = _pm(at, [])
    at.set_active_manager(pm)
    key = T.config_key("fp", 1, T.topology_signature())
    bad = T.make_record(CONFIG, 1.0, DIMS)
    bad["dims"] = ["old"]
    path = tmp_path / "tuned_configs.json"
    path.write_text(json.dumps({"version": 1, "configs": {key: bad}}))
    assert at.announce_model(fingerprint="fp", world=1) == key
    assert not pm.loop_status()["warm_started"]
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MEMORY", "0")
    assert at.announce_model(fingerprint="fp", world=1) is None


def test_tpu_state_announces_the_model(tmp_path, monkeypatch):
    """``elastic.TpuState`` announces its trees to the active tuner."""
    from horovod_tpu_torch.elastic.state import TpuState
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_MEMORY_DIR", str(tmp_path))
    pm = _pm(at, [])
    at.set_active_manager(pm)
    model = torch.nn.Linear(4, 2)
    TpuState(params=model)
    assert pm._memory_key == T.config_key(
        T.model_fingerprint({"params": model}), 1, T.topology_signature())
