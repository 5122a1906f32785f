"""horovod_tpu_torch's GSPMD ZeRO plane (``ops.gspmd`` on a ``DeviceMesh``,
``ops.xla_collectives``) against horovod_tpu's, on four gloo ranks
(started once per test process by ``_torch_port_pool.part_results``)
against the reference's jitted step on a 4-device CPU mesh.

The problem is the reference's stage-parity toy (tests/test_zero_stages.py:
w (32, 3), b (16,), AdamW(1e-2, wd 1e-3), 2 steps, the batch (8, 32)
sharded over the ranks) with a leaf c (5,) whose dim 0 does not divide 4,
so that it stays replicated and is listed.  Its bars are the reference's:
losses relative 1e-5 and parameters rtol 1e-6, atol 1e-7 between stages,
and, against optax's AdamW, 1e-5 per weight (the port's AdamW note,
ROADMAP queue 3).  On int8 the gradients ride the two-pass wire with error
feedback; the compiled reference's quantizer scale is one ulp off the
port's in a few blocks (ROADMAP queue 3), so a residual element may differ
by one grid step there and the parameters by what Adam makes of that.
The wire accounting is plain arithmetic and equals the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.checkpoint import zero as ckz_jax
from horovod_tpu.core import state as state_jax
from horovod_tpu.core.config import Config
from horovod_tpu.ops import dispatch as D_jax
from horovod_tpu.ops import gspmd as G_jax
from horovod_tpu.ops import quantization as Q_jax
from horovod_tpu.ops import xla_collectives as XC_jax
from horovod_tpu.parallel import mesh as mesh_jax

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.ops import quantization as Q
from horovod_tpu_torch.ops import xla_collectives as XC

import _torch_port_parallel_workers as workers
import _torch_port_pool as pool

WORLD = pool.WORLD
STAGES = workers.STAGES
KEYS = workers.PARAM_KEYS
REF_CKPT_STEPS = 3


def _ref_loss(p, batch):
    (x,) = batch
    return jnp.mean((x @ p["w"]) ** 2) * 0.1 + jnp.sum(p["b"] ** 2) + \
        jnp.sum(p["c"] ** 2)


_REF = {}


def _reference(stage, comp, steps=2):
    """The reference's make_zero_train_step on the toy: (mesh, params,
    state, loss)."""
    key = (stage, comp, steps)
    if key not in _REF:
        inputs = pool.part_inputs("gspmd")
        mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
        params = {k: jnp.asarray(inputs["param." + k]) for k in KEYS}
        x = jnp.asarray(inputs["x"].reshape(-1, inputs["x"].shape[-1]))
        fns = G_jax.make_zero_train_step(
            _ref_loss, optax.adamw(1e-2, weight_decay=1e-3), mesh,
            stage=stage, compression=comp)
        p, s = fns.init(params)
        loss = None
        for _ in range(steps):
            p, s, loss = fns.step(p, s, (x,))
        _REF[key] = (mesh, p, s, float(loss))
    return _REF[key]


def _write_reference_checkpoint(out_dir):
    mesh, _, s, _ = _reference(2, "int8", REF_CKPT_STEPS)
    ckz_jax.save_zero_state(f"{out_dir}/ref_int8", s, step=REF_CKPT_STEPS,
                            mesh=mesh, axis_name="data")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "gspmd",
                             prepare=_write_reference_checkpoint)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("stage", STAGES)
def test_gspmd_stage_matches_reference(ranks, stage):
    _, p_ref, _, loss_ref = _reference(stage, None)
    for r, res in enumerate(ranks):
        got = res[(stage, None)]
        assert abs(got["loss"] - loss_ref) <= 1e-5 * abs(loss_ref), r
        for k in KEYS:
            np.testing.assert_allclose(_np(got["params"][k]),
                                       np.asarray(p_ref[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"rank {r} {k}")
        # Moments of the leaves whose dim 0 divides are dim-0 shards;
        # parameters are shards only at stage 3, and c never.
        assert got["moment_placements"] == ["(Shard(dim=0),)"]
        want = "(Shard(dim=0),)" if stage == 3 else "(Replicate(),)"
        assert got["param_placements"] == {"b": want, "w": want,
                                           "c": "(Replicate(),)"}
        assert got["wrapped"] == "OptimizerState"


@pytest.mark.parametrize("stage", STAGES[1:])
def test_gspmd_stages_agree(ranks, stage):
    """The reference's own bar between stages."""
    base, got = ranks[0][(1, None)], ranks[0][(stage, None)]
    assert abs(got["loss"] - base["loss"]) <= 1e-5 * abs(base["loss"])
    for k in KEYS:
        torch.testing.assert_close(got["params"][k], base["params"][k],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stage,comp", [(s, c) for s in STAGES
                                        for c in (None, "int8")])
def test_gspmd_residency_matches_reference(ranks, stage, comp):
    mesh, p, s, _ = _reference(stage, comp)
    want = G_jax.residency_report((p, s), mesh)
    for res in ranks:
        got = res[(stage, comp)]["report"]
        assert got == want
    if stage == 3:
        assert want["ratio_to_ideal"] <= 1.3, want


@pytest.mark.parametrize("stage", STAGES)
def test_gspmd_compression_none_is_bit_equal(ranks, stage):
    for res in ranks:
        a, b = res[(stage, None)], res[(stage, "none")]
        assert a["loss"] == b["loss"]
        for k in KEYS:
            assert torch.equal(a["params"][k], b["params"][k])
        assert b["wrapped"] == "OptimizerState"


@pytest.mark.parametrize("stage", STAGES)
def test_gspmd_int8_error_feedback_matches_reference(ranks, stage):
    """The residual is the world × size flat fp32 DTensor, rank r's slice
    its own.  Every element is within one grid step of the reference's
    (the scale's ulp can move a rounding); the gradients' fp32 arithmetic
    differs in the last bits, so nearly all are within 1e-6."""
    _, p_ref, s_ref, loss_ref = _reference(stage, "int8")
    close = total = 0
    for r, res in enumerate(ranks):
        got = res[(stage, "int8")]
        assert got["wrapped"] == "_ZeroState"
        assert abs(got["loss"] - loss_ref) <= 1e-5 * abs(loss_ref), r
        for k in KEYS:
            np.testing.assert_allclose(_np(got["params"][k]),
                                       np.asarray(p_ref[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"rank {r} {k}")
            local, placements, shape = got["residual"][k]
            n = local.numel()
            assert placements == "(Shard(dim=0),)"
            assert shape == (WORLD * n,)
            ref = np.asarray(s_ref.residual[k])[r * n:(r + 1) * n]
            mine = _np(local)
            assert np.abs(mine).max() > 0
            # Both residuals lie within half a grid step of 0.
            step = 2 * max(np.abs(ref).max(), np.abs(mine).max())
            assert np.all(np.abs(mine - ref) <= step)
            close += int((np.abs(mine - ref) <= 1e-6).sum())
            total += n
    assert close >= 0.99 * total, (close, total)


def test_gspmd_records_wire_bytes(ranks):
    """Every int8 step adds the analytic plan of its gradients, the
    reference's plan_allreduce_step: 2 steps at each stage and the
    checkpointed run's 3."""
    spec = Q_jax.QuantSpec(8, 256)
    sizes = [int(np.prod(v.shape)) for v in pool.GSPMD_PARAMS.values()]
    plan = XC_jax.plan_allreduce_step(sizes, local_size=WORLD,
                                      cross_size=1, spec=spec)
    steps = 2 * len(STAGES) + 3
    for res in ranks:
        assert res["wire"] == (steps * plan.raw, steps * plan.sent)
    assert plan.raw / plan.sent > 2.0


def test_gspmd_checkpoint_reference_to_port(ranks):
    """The reference's int8 stage-2 step restores in the port bit for
    bit: sizes, count, the dense moments and every rank's residual."""
    _, _, s_ref, _ = _reference(2, "int8", REF_CKPT_STEPS)
    want = _leaves(s_ref)
    for res in ranks:
        got = {k: _np(v) for k, v in res["restored"].items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gspmd_checkpoint_port_to_reference(ranks):
    mesh, _, s_ref, _ = _reference(2, "int8", REF_CKPT_STEPS)
    root = pool.part_dir("gspmd") + "/port_int8"
    back = ckz_jax.restore_zero_state(root, s_ref, mesh=mesh,
                                      axis_name="data")
    got = _leaves(back)
    saved = {k: _np(v) for k, v in ranks[0]["saved"].items()}
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k].reshape(v.shape), v, err_msg=k)
    # Every rank wrote the same replicated values and its own residual.
    for res in ranks[1:]:
        for k, v in res["saved"].items():
            np.testing.assert_array_equal(_np(v), saved[k], err_msg=k)


def test_leaf_spec_and_constrain_match_reference(ranks):
    """A leaf shards on dim 0 where it divides the world (and was asked
    to), as the reference's PartitionSpec says; constrain slices to this
    rank's rows and gathers back."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    as_port = {"PartitionSpec('data',)": "(Shard(dim=0),)",
               "PartitionSpec()": "(Replicate(),)"}
    for shape in workers.LEAF_SHAPES:
        for sharded in (True, False):
            want = as_port[str(G_jax.leaf_spec(jnp.zeros(shape), mesh,
                                               sharded))]
            for res in ranks:
                assert res["placement"][(shape, sharded)] == want, shape
    for r, res in enumerate(ranks):
        got = res["placement"]["constrain"]
        assert got["w"][0] == "(Shard(dim=0),)" and got["w"][2]
        assert torch.equal(got["w"][1],
                           torch.arange(96.0).reshape(32, 3)[8 * r:8 * r + 8])
        assert got["c"][0] == "(Replicate(),)" and got["c"][2]


def test_gspmd_sgd_momentum_matches_reference(ranks):
    """Stage 3 with SGD(0.05, momentum 0.9) against optax.sgd: the trace
    state's paths and residency are the reference's, the values its own
    to 1e-5."""
    inputs = pool.part_inputs("gspmd")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    fns = G_jax.make_zero_train_step(_ref_loss, optax.sgd(0.05, momentum=0.9),
                                     mesh, stage=3)
    p, s = fns.init({k: jnp.asarray(inputs["param." + k]) for k in KEYS})
    x = jnp.asarray(inputs["x"].reshape(-1, inputs["x"].shape[-1]))
    for _ in range(2):
        p, s, loss = fns.step(p, s, (x,))
    want = G_jax.residency_report((p, s), mesh)
    for res in ranks:
        got = res["sgd"]
        assert got["report"] == want
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for k in KEYS:
            np.testing.assert_allclose(_np(got["params"][k]),
                                       np.asarray(p[k]), rtol=1e-5,
                                       atol=1e-5)


def test_world4_meshes_match_reference(ranks):
    """mesh() is the 1-D "data" mesh over the world; create_mesh lays the
    ranks out row-major, as the reference's reshape of its devices."""
    devs = jax.devices()[:WORLD]
    ref = mesh_jax.create_mesh({"data": 2, "model": 2}, devices=devs)
    grid = [[devs.index(d) for d in row] for row in ref.devices.tolist()]
    for res in ranks:
        assert res["mesh"]["names"] == ("data",)
        assert res["mesh"]["shape"] == (WORLD,)
        assert res["mesh"]["grid"] == grid


def _reference_scheduled(wire, pin, what):
    """The reference's scheduled collective under shard_map on a 2 x 2
    ("local", "cross") mesh, the per-rank outputs stacked."""
    from horovod_tpu.compat import shard_map
    from horovod_tpu.ops import collective as C_jax
    from jax.sharding import PartitionSpec as P
    inputs = pool.part_inputs("gspmd")
    devs = np.array(jax.devices()[:WORLD]).reshape(2, 2)
    mesh = Mesh(devs, ("local", "cross"))
    pair = ("local", "cross")
    spec = None if wire is None else Q_jax.QuantSpec(8, 256)
    old = state_jax.global_state.config
    cfg = Config.from_env()
    cfg.hierarchical_allreduce_pin = cfg.hierarchical_allgather_pin = pin
    state_jax.global_state.config = cfg
    D_jax.reset()
    try:
        if what == "all_to_all":
            fn = lambda t: XC_jax.all_to_all_wire(t[0], "local", spec)[None]
            x = inputs["sched_v"]
        elif what == "reducescatter":
            fn = lambda t: XC_jax.reducescatter_scheduled(
                t[0], C_jax.Average, pair, spec=spec)[None]
            x = inputs["sched_rs"]
        elif what == "allreduce":
            fn = lambda t: XC_jax.allreduce_scheduled(
                t[0], C_jax.Sum, pair, spec=spec)[None]
            x = inputs["sched_x"]
        else:
            fn = lambda t: XC_jax.allgather_scheduled(t[0], pair,
                                                      spec=spec)[None]
            x = inputs["sched_x"]
        out = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(pair),),
                                out_specs=P(pair), check_vma=False))(
            jnp.asarray(x))
    finally:
        state_jax.global_state.config = old
    return np.asarray(out)


SCHEDULED = [(w, p, c) for w in (None, "int8") for p in (False, True)
             for c in ("allreduce", "allgather")] + \
    [(w, None, c) for w in (None, "int8")
     for c in ("reducescatter", "all_to_all")]


@pytest.mark.parametrize("wire,pin,what", SCHEDULED)
def test_scheduled_collectives_match_reference(ranks, wire, pin, what):
    """Over a 2 x 2 ("local", "cross") mesh, flat and hierarchical: the
    fp32 wire to 1e-5, int8 within one grid step of the reduced value
    (the compiled reference's quantizer scale, ROADMAP queue 3, and the
    fp32 sums' order), and on average within a tenth of one."""
    want = _reference_scheduled(wire, bool(pin), what)
    key = (wire, pin, what) if pin is not None else (wire, what)
    got = np.stack([_np(r["scheduled"][key]) for r in ranks])
    assert got.shape == want.shape
    if wire is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        step = np.abs(want).max() / 127 * (WORLD if what == "allreduce"
                                           else 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=step)
        # A moved rounding is rare; elsewhere only fp32 summation order.
        assert np.abs(got - want).mean() <= step / 10


# ---------------------------------------------------------------------------
# schedule selection and the wire accounting (one process)
# ---------------------------------------------------------------------------

CASES = [(False, None), (True, None), (True, False), (False, True),
         (True, True), (False, False)]


@pytest.mark.parametrize("flag,pin", CASES)
def test_choose_schedule_precedence(flag, pin):
    """The pin, then the boolean, else flat — the reference's precedence
    below its dispatch table, which the port has not yet."""
    old = state_jax.global_state.config
    cfg = Config.from_env()
    cfg.hierarchical_allreduce = cfg.hierarchical_allgather = flag
    cfg.hierarchical_allreduce_pin = cfg.hierarchical_allgather_pin = pin
    state_jax.global_state.config = cfg
    D_jax.reset()
    hvd.init(device="cpu")
    try:
        for kind in ("allreduce", "allgather"):
            setattr(global_state, f"hierarchical_{kind}", flag)
            setattr(global_state, f"hierarchical_{kind}_pin", pin)
            for nbytes in (1 << 10, 1 << 24):
                assert XC.choose_schedule(kind, nbytes) == \
                    XC_jax.choose_schedule(kind, nbytes), (kind, nbytes)
    finally:
        hvd.shutdown()
        state_jax.global_state.config = old


@pytest.mark.parametrize("value,want", [(None, "flat"), ("1", "hier"),
                                        ("0", "flat")])
def test_choose_schedule_reads_the_knob(monkeypatch, value, want):
    """Before init() and after it the knob decides: set, it pins."""
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        monkeypatch.delenv(prefix + "HIERARCHICAL_ALLREDUCE", raising=False)
    if value is not None:
        monkeypatch.setenv("HVD_TPU_HIERARCHICAL_ALLREDUCE", value)
    assert XC.choose_schedule("allreduce", 1 << 20) == want
    hvd.init(device="cpu")
    try:
        assert XC.choose_schedule("allreduce", 1 << 20) == want
        assert global_state.hierarchical_allreduce_pin == (
            None if value is None else value == "1")
    finally:
        hvd.shutdown()


SIZES = [1 << 20, (1 << 20) + 13, 96, 5, 8192 * 512, 8 * 512 * 2048, 1]
WIRES = [("int8", 256), ("int4", 256), ("int8", 32), ("bf16", None),
         ("fp16", None), ("none", None)]


def _wire(name, block, torch_side):
    if name.startswith("int"):
        return ((Q if torch_side else Q_jax).QuantSpec(int(name[3]), block),
                None)
    if name == "none":
        return None, None
    dtype = {"bf16": (torch.bfloat16, jnp.bfloat16),
             "fp16": (torch.float16, jnp.float16)}[name]
    return None, dtype[0 if torch_side else 1]


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: f"{w[0]}-{w[1]}")
def test_wire_bytes_match_reference(wire):
    mine, ref = _wire(*wire, True), _wire(*wire, False)
    for n in SIZES:
        for fn in ("wire_bytes_of", "allreduce_wire_bytes",
                   "reducescatter_wire_bytes", "allgather_wire_bytes"):
            assert getattr(XC, fn)(n, *mine) == \
                getattr(XC_jax, fn)(n, *ref), (fn, n)
        for L, C in ((4, 2), (2, 2), (8, 1), (1, 4)):
            assert XC.hierarchical_allreduce_wire_bytes(n, L, C, *mine) == \
                XC_jax.hierarchical_allreduce_wire_bytes(n, L, C, *ref)


@pytest.mark.parametrize("hier", [False, True])
@pytest.mark.parametrize("wire", WIRES[:4], ids=lambda w: f"{w[0]}-{w[1]}")
def test_plan_allreduce_step_matches_reference(wire, hier):
    """The flagship's nine leaves and the toy's, flat and with the
    hierarchical schedule pinned on."""
    mine, ref = _wire(*wire, True), _wire(*wire, False)
    flagship = [8192 * 512, 512 * 512, 512, 8 * 512, 8 * 512,
                8 * 512 * 1536, 8 * 512 * 512, 8 * 512 * 2048,
                8 * 2048 * 512]
    old = state_jax.global_state.config
    cfg = Config.from_env()
    cfg.hierarchical_allreduce_pin = hier
    state_jax.global_state.config = cfg
    D_jax.reset()
    hvd.init(device="cpu")
    global_state.hierarchical_allreduce_pin = hier
    try:
        for sizes in (flagship, [96, 16, 5]):
            for L, C in ((1, 1), (4, 1), (4, 2), (2, 2)):
                got = XC.plan_allreduce_step(sizes, L, C, *mine)
                want = XC_jax.plan_allreduce_step(sizes, L, C, *ref)
                assert tuple(got) == tuple(want), (sizes, L, C)
    finally:
        hvd.shutdown()
        state_jax.global_state.config = old


def test_flat_wire_ratios_at_block_256():
    """3.94x (int8) and 7.76x (int4) fewer bytes than fp32, as the
    reference's BENCH_XLA_QUANT.json records for block 256."""
    n = 1 << 20
    raw8, sent8 = XC.allreduce_wire_bytes(n, Q.QuantSpec(8, 256))
    raw4, sent4 = XC.allreduce_wire_bytes(n, Q.QuantSpec(4, 256))
    assert round(raw8 / sent8, 2) == 3.94
    assert round(raw4 / sent4, 2) == 7.76
    rawc, sentc = XC.allreduce_wire_bytes(n, wire_dtype=torch.bfloat16)
    assert rawc / sentc == 2.0


def test_stage_outside_1_to_3_raises():
    hvd.init(device="cpu")
    try:
        from horovod_tpu_torch.ops import gspmd
        for stage in (0, 4):
            with pytest.raises(ValueError, match="1, 2 or 3"):
                gspmd.make_zero_train_step(workers.gspmd_loss,
                                           torch.optim.SGD, hvd.mesh(),
                                           stage=stage)
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="1, 2 or 3"):
        G_jax.make_zero_train_step(_ref_loss, optax.sgd(0.1),
                                   Mesh(np.array(jax.devices()[:1]),
                                        ("data",)), stage=4)
