"""horovod_tpu_torch's collective API on four gloo ranks (a 2 x 2 cross x
local topology; the ranks are spawned once per test process, by
``_torch_port_pool``) against horovod_tpu's.

The compressed schedules — ``compressed_allreduce`` (int8, int4, bf16,
fp16; Sum, Average, pre/postscale, a bf16 input), the hierarchical
allreduce, ``compressed_reducescatter`` and ``compressed_allgather`` (the
world, and ``("local", "cross")`` nested) — are held to the
reference run under ``shard_map`` on a 4-device CPU mesh (``"data"``, or
``("cross", "local")`` 2 x 2) on the same seeded inputs.  Tolerance: the
largest difference is at most one second-pass grid step (the block's
scale, or the cast dtype's spacing), and at least 99.9% of the elements
agree within 1e-6 of the largest magnitude (for a bf16 input, whose
result is bf16, at least 99% are equal: an fp32 difference in the last
bit can flip the final rounding).  Only the fp32 summation order
differs, and the reference's compiled quantizer multiplies by 1/qmax
where the port divides (ROADMAP.md queue 3).

The uncompressed collectives, the async handles, join, barrier, the object
collectives, the errors and the session knob are held to the reference's
semantics; the bytes each pass moves are ``wire_bytes``'.  Three ranks laid
out as hosts of 2 and 1 slots init and reduce over the world, and refuse
the ("local", "cross") axis."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.ops import collective as Cj
from horovod_tpu.ops import quantization as Qj

import _torch_port_pool as pool

WORLD = pool.WORLD
OPS = {"sum": Cj.Sum, "average": Cj.Average}
WIRE = {"int8": dict(spec=Qj.QuantSpec(8, 256)),
        "int4": dict(spec=Qj.QuantSpec(4, 256)),
        "bf16": dict(wire_dtype=jnp.bfloat16),
        "fp16": dict(wire_dtype=jnp.float16)}
QMAX = {"int8": 127, "int4": 7}
SPACING = {"bf16": 2.0 ** -7, "fp16": 2.0 ** -10}  # relative, at the max


@pytest.fixture(scope="module")
def inputs():
    return pool.collective_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.results(tmp_path_factory)["collectives"]


def _reference_case(name, inp):
    """The reference's schedule for case ``name`` on one rank's inputs,
    inside shard_map."""
    kind, wire, variant = name.split("-")
    kw = WIRE[wire]
    if kind == "allreduce":
        if variant == "bf16input":
            return Qj.compressed_allreduce(inp["x"].astype(jnp.bfloat16),
                                           "data", Cj.Sum, **kw)
        if variant == "scaled":
            return Qj.compressed_allreduce(inp["x"], "data", Cj.Average,
                                           prescale=0.5, postscale=3.0, **kw)
        return Qj.compressed_allreduce(inp["x"], "data", OPS[variant], **kw)
    if kind == "hier":
        return Qj.compressed_allreduce_hierarchical(
            inp["x"], "local", "cross", OPS[variant], **kw)
    if kind == "reducescatter":
        return Qj.compressed_reducescatter(inp["rs"], "data", OPS[variant],
                                           **kw)
    if variant == "world":
        return Qj.compressed_allgather(inp["ag"], "data", **kw)
    return Qj.compressed_allgather(inp["ag"], ("local", "cross"), **kw)


def _per_rank(names, inputs, axes):
    """The cases ``names`` on every rank under one jitted shard_map;
    returns {name: per-rank results stacked}.  ``axes`` names the mesh:
    ("data",) flat, ("cross", "local") 2 x 2, rank = cross * 2 + local."""
    devices = np.array(jax.devices()[:WORLD])
    if len(axes) == 2:
        devices = devices.reshape(2, 2)
    spec = P(axes if len(axes) == 2 else axes[0])

    def body(inp):
        inp = {k: v[0] for k, v in inp.items()}
        return {n: _reference_case(n, inp)[None] for n in names}

    f = jax.jit(shard_map(body, mesh=Mesh(devices, axes), in_specs=spec,
                          out_specs=spec, check_vma=False))
    out = f({k: jnp.asarray(v) for k, v in inputs.items()})
    return {n: np.asarray(v.astype(jnp.float32)) for n, v in out.items()}


COMPRESSED = (
    [f"allreduce-{w}-{op}" for w in ("int8", "int4", "bf16", "fp16")
     for op in ("sum", "average")]
    + ["allreduce-int8-scaled", "allreduce-int8-bf16input",
       "allreduce-bf16-bf16input", "hier-int8-sum", "hier-int4-sum",
       "hier-bf16-sum", "hier-int8-average", "reducescatter-int8-sum",
       "reducescatter-int8-average", "reducescatter-int4-sum",
       "reducescatter-bf16-average", "allgather-int8-world",
       "allgather-int4-world", "allgather-bf16-world",
       "allgather-int8-nested", "allgather-int4-nested",
       "allgather-bf16-nested"])


JOINT = [n for n in COMPRESSED
         if n.startswith("hier") or n.endswith("nested")]


@pytest.fixture(scope="module")
def references(inputs):
    flat = [n for n in COMPRESSED if n not in JOINT]
    return {**_per_rank(flat, inputs, ("data",)),
            **_per_rank(JOINT, inputs, ("cross", "local"))}


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name", COMPRESSED)
def test_compressed_schedules_match_reference(ranks, references, name):
    ref = references[name]
    wire = name.split("-")[1]
    big = np.abs(ref).max()
    step = big / QMAX[wire] if wire in QMAX else big * SPACING[wire]
    for r in range(WORLD):
        got = ranks[r]["compressed"][name].float().numpy()
        assert got.shape == ref[r].shape, name
        diff = np.abs(got - ref[r])
        assert diff.max() <= step, (name, r, diff.max(), step)
        if name.endswith("bf16input"):
            assert ranks[r]["compressed"][name].dtype == torch.bfloat16
            assert (diff == 0).mean() >= 0.99, (name, r)
        else:
            assert (diff <= 1e-6 * big).mean() >= 0.999, (name, r)
    if name.startswith(("allreduce", "hier", "allgather")):
        for r in range(1, WORLD):   # the same result on every rank
            assert torch.equal(ranks[r]["compressed"][name],
                               ranks[0]["compressed"][name])


@pytest.mark.timeout(150)
@pytest.mark.parametrize("wire", ["int8", "int4", "bf16", "fp16"])
def test_wire_bytes_are_the_compressed_ones(ranks, wire):
    """One allreduce of 2048 fp32 elements on four ranks: pass 1 sends the
    whole (padded) tensor, pass 2 this rank's quarter, each as payload plus
    scales, and no fp32 payload."""
    size = {"torch.int8": 1, "torch.float32": 4, "torch.bfloat16": 2,
            "torch.float16": 2}
    for res in ranks:
        log = res[f"wire-{wire}"]
        passes = {"all_to_all_single": 0, "all_gather_into_tensor": 0}
        for call, dtype, numel in log:
            passes[call] += size[dtype] * numel
        if wire in QMAX:
            spec = Qj.QuantSpec(int(wire[3]), 256)
            expected = (Qj.wire_bytes(2048, spec), Qj.wire_bytes(512, spec))
            assert [d for _, d, _ in log] == ["torch.int8", "torch.float32"] * 2
        else:
            expected = (2 * 2048, 2 * 512)
            assert len(log) == 2 and "float32" not in str(log)
        assert (passes["all_to_all_single"],
                passes["all_gather_into_tensor"]) == expected


@pytest.mark.timeout(150)
def test_compressed_grouped_allreduce_goes_member_by_member(ranks):
    for res in ranks:
        got = res["grouped-int8"]
        assert torch.equal(got[0], res["compressed"]["allreduce-int8-sum"])
        assert torch.equal(got[1], res["rs-allreduce-int8"])


@pytest.mark.timeout(150)
def test_allgather_unequal_and_joint_order(ranks):
    """Rank r contributes r + 1 rows; the world gather is in rank order,
    the ("local", "cross") gather local-major, as the reference's joint
    mesh axis orders it."""
    mine = [np.arange(3.0 * (r + 1)).reshape(r + 1, 3) + 100 * r
            for r in range(WORLD)]
    local_major = [0, 2, 1, 3]        # rank = cross * 2 + local
    for res in ranks:
        np.testing.assert_array_equal(res["allgather-unequal"].numpy(),
                                      np.concatenate(mine))
        np.testing.assert_array_equal(
            res["allgather-joint"].numpy(),
            np.concatenate([mine[r] for r in local_major]))
        np.testing.assert_array_equal(res["async"]["allgather"].numpy(),
                                      np.concatenate(mine))


@pytest.mark.timeout(150)
def test_alltoall_splits(ranks):
    """Rank s sends splits[s][d] = (s + d) % 3 rows to rank d; each receives
    the pieces in rank order and their row counts."""
    splits = [[(s + d) % 3 for d in range(WORLD)] for s in range(WORLD)]

    def sent(s, d):
        off = sum(splits[s][:d])
        return np.arange(off, off + splits[s][d], dtype=np.float64)[:, None] \
            * 10 + s

    for d, res in enumerate(ranks):
        for got, recv in (res["alltoall"], res["async"]["alltoall"]):
            assert recv.dtype == torch.int32
            assert recv.tolist() == [splits[s][d] for s in range(WORLD)]
            np.testing.assert_array_equal(
                got.numpy(), np.concatenate([sent(s, d) for s in range(WORLD)]))
        got, recv = res["alltoall-equal"]
        assert recv.tolist() == [2] * WORLD
        np.testing.assert_array_equal(
            got.numpy(), [8 * s + 2 * d + i for s in range(WORLD)
                          for i in range(2)])


@pytest.mark.timeout(150)
def test_reducescatter(ranks):
    ints = [np.arange(8) * (r + 1) + r for r in range(WORLD)]
    total = np.sum(ints, axis=0)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["reducescatter-sum"].numpy(),
                                      total[2 * r: 2 * r + 2])
        got = res["reducescatter-int-average"]
        assert got.dtype == torch.int32       # floor-divided, as allreduce
        np.testing.assert_array_equal(got.numpy(),
                                      total[2 * r: 2 * r + 2] // WORLD)


@pytest.mark.timeout(150)
def test_async_handles(ranks, inputs):
    x = inputs["x"]
    for res in ranks:
        assert all(res["poll"].values())
        np.testing.assert_allclose(res["async"]["allreduce"].numpy(),
                                   x.sum(0) * 0.5, rtol=1e-6, atol=1e-6)
        # A compressed async call is the synchronous compressed allreduce.
        np.testing.assert_array_equal(
            res["async"]["allreduce-int8"].numpy(),
            res["compressed"]["allreduce-int8-average"].numpy())
        np.testing.assert_array_equal(res["async"]["broadcast"].numpy(),
                                      [[300.0, 301.0, 302.0]])


@pytest.mark.timeout(150)
def test_join_barrier_and_objects(ranks):
    for res in ranks:
        assert res["join"] == WORLD - 1
        assert res["broadcast_object"] == {"from": 2, "list": [2, 2, 2]}
        assert res["allgather_object"] == [("rank", r) * r
                                           for r in range(WORLD)]


@pytest.mark.timeout(150)
def test_explicit_compression_errors(ranks):
    """An explicit compressor refuses what a lossy wire cannot carry: an
    integer tensor, Min, and a reducescatter with Max (which, without a
    compressor, reduces as Average: test below)."""
    errors = ranks[0]["errors"]
    for label in ("int-explicit", "min-explicit", "rs-int-explicit",
                  "rs-max"):
        assert "compression requires a floating tensor and op Sum/Average" \
            in errors[label], label
    assert "not divisible" in errors["rs-ragged"]
    assert "axis_name" in errors["axis"]


@pytest.mark.timeout(150)
def test_reducescatter_reduces_other_ops_as_average(ranks, inputs):
    """Max, Min and Product reduce as Average, as the reference's eager
    reducescatter does (collective.py:745): each rank's chunk of the mean,
    the reference's Average under shard_map within 1e-6."""
    def body(x):
        return Cj.reducescatter(x[0, :4], op=Cj.Average,
                                axis_name="data")[None]

    ref = np.asarray(jax.jit(shard_map(
        body, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)),
        in_specs=P("data"), out_specs=P("data"), check_vma=False))(
            jnp.asarray(inputs["x"])))
    for r, res in enumerate(ranks):
        got = res["reducescatter-other-ops"]
        for op in ("max", "min", "product"):
            assert torch.equal(got[op], got["average"]), (r, op)
        np.testing.assert_allclose(got["max"].numpy(), ref[r], rtol=0,
                                   atol=1e-6)


JOINT_CASES = ["broadcast", "alltoall", "reducescatter", "reducescatter-sum",
               "reducescatter-int8"]


@pytest.fixture(scope="module")
def joint_references(inputs):
    axis = ("local", "cross")

    def body(x, rs):
        x, rs = x[0], rs[0]
        return {"broadcast": Cj.broadcast(x, root_rank=1, axis_name=axis),
                "alltoall": Cj.alltoall(rs, axis_name=axis),
                "reducescatter": Cj.reducescatter(rs, op=Cj.Average,
                                                  axis_name=axis),
                "reducescatter-sum": Cj.reducescatter(rs, op=Cj.Sum,
                                                      axis_name=axis),
                "reducescatter-int8": Cj.reducescatter(
                    rs, op=Cj.Average, axis_name=axis, compression="int8")}

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                ("cross", "local"))
    spec = P(("cross", "local"))
    out = jax.jit(shard_map(lambda x, rs: {k: v[None] for k, v in
                                           body(x, rs).items()},
                            mesh=mesh, in_specs=(spec, spec),
                            out_specs=spec, check_vma=False))(
        jnp.asarray(inputs["x"]), jnp.asarray(inputs["rs"]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name", JOINT_CASES)
def test_joint_axis_matches_reference(ranks, joint_references, inputs,
                                      name):
    """broadcast, alltoall and reducescatter over ("local", "cross") on the
    2 x 2 layout: the reference's compiled collectives over that axis on
    the ("cross", "local") mesh, whose members count local-major.  Moves
    exactly; sums within 1e-6 of the largest magnitude; the int8 wire
    within one grid step (the reference's compiled quantizer multiplies)."""
    for r, res in enumerate(ranks):
        got = res["joint"][name]
        got = (got[0] if isinstance(got, tuple) else got).numpy()
        ref = joint_references[name][r]
        assert got.shape == ref.shape, name
        if name in ("broadcast", "alltoall"):
            np.testing.assert_array_equal(got, ref)
        else:
            big = np.abs(ref).max()
            step = big / 127 if name.endswith("int8") else 1e-6 * big
            assert np.abs(got - ref).max() <= step, (name, r)


@pytest.mark.timeout(150)
def test_joint_axis_alltoall_with_splits(ranks):
    """Member j (local j // 2 of host j % 2) sends splits[j][d] rows to
    member d and receives the pieces in member order."""
    member = [0, 2, 1, 3]                  # rank = cross * 2 + local
    order = [member.index(j) for j in range(WORLD)]   # member -> rank
    splits = [[(s + d) % 3 for d in range(WORLD)] for s in range(WORLD)]

    def sent(src, dst):
        """What rank src sends to member dst: its pieces are in member
        order."""
        off = sum(splits[src][:dst])
        return np.arange(off, off + splits[src][dst],
                         dtype=np.float64)[:, None] * 10 + src

    for rank, res in enumerate(ranks):
        got, recv = res["joint"]["alltoall-splits"]
        d = member[rank]
        assert recv.tolist() == [splits[order[j]][d] for j in range(WORLD)]
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate([sent(order[j], d)
                                         for j in range(WORLD)]))


@pytest.mark.timeout(150)
def test_session_knob_rounds_direct_allreduce_only(ranks, inputs):
    x = inputs["x"]
    for res in ranks:
        knob = res["knob"]
        np.testing.assert_array_equal(knob["allreduce"].numpy(),
                                      knob["explicit"].numpy())
        np.testing.assert_array_equal(
            knob["explicit"].numpy(),
            res["compressed"]["allreduce-int8-average"].numpy())
        assert not np.allclose(knob["allreduce"].numpy(), x.mean(0),
                               rtol=0, atol=1e-6)
        np.testing.assert_array_equal(knob["max"].numpy(), x.max(0))
        assert knob["int"].dtype == torch.int32
        np.testing.assert_array_equal(
            knob["int"].numpy(),
            np.sum([np.arange(8) * (r + 1) + r for r in range(WORLD)],
                   axis=0) // WORLD)
        np.testing.assert_allclose(knob["optimizer"].numpy(), x.mean(0),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(knob["grouped"][0], knob["explicit"])
        assert torch.equal(knob["grouped"][1], knob["int"])


@pytest.mark.timeout(150)
def test_uneven_layout_inits_and_reduces_over_the_world(tmp_path_factory):
    """Hosts of 2 and 1 slots: local sizes 2, 2, 1, cross size 2, which is
    no grid.  Every rank inits, allreduces and allgathers over the world,
    and refuses the ("local", "cross") axis with the same error."""
    ranks = pool.results(tmp_path_factory)["uneven"]
    world = pool.UNEVEN_WORLD
    x = [np.arange(600.0, dtype=np.float32).reshape(2, 300) / 7 * (r + 1)
         for r in range(world)]
    total = np.sum(x, axis=0)
    step = np.abs(total).max() / 127
    for r, res in enumerate(ranks):
        assert res["topology"] == [r, world, [0, 1, 0][r], [2, 2, 1][r],
                                   [0, 0, 1][r], 2]
        np.testing.assert_allclose(res["sum"].numpy(), total, rtol=1e-6)
        assert np.abs(res["int8"].numpy() - total).max() <= step
        assert torch.equal(res["int8"], ranks[0]["int8"])
        np.testing.assert_array_equal(
            res["allgather"].numpy(),
            np.concatenate([x[s][:s + 1] for s in range(world)]))
        assert "two-level topology" in res["joint"]
