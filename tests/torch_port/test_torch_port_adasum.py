"""horovod_tpu_torch's Adasum (``ops/adasum.py``, ``allreduce(op=Adasum)``,
``DistributedOptimizer(op=Adasum)``) against horovod_tpu's, on four gloo
ranks laid out 2 x 2 (and ranks 0-2 in a flat world of three), started
once per test process by ``_torch_port_pool.part_results``.

The reference runs under ``shard_map`` on a 4-device CPU mesh (``"data"``,
or ``("cross", "local")`` 2 x 2) on the same seeded inputs.  Tolerance:
the port sums the dot products and norms in another order (per segment,
then over the group, where the reference's grouped ``psum`` adds its own
way), so results agree within 1e-5 of the largest magnitude, fp32; on
the hierarchical schedule's int8 or bf16 intra-node wire within one grid
step of that wire.  Every rank holds the same result, bit for bit.  The
combine itself (``adasum_pair``, ``adasum_tree``) agrees within 1e-6
normwise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd_jax
from horovod_tpu.compat import shard_map
from horovod_tpu.ops import adasum as Aj
from horovod_tpu.ops import collective as Cj
from horovod_tpu.ops import quantization as Qj
from horovod_tpu_torch.ops import adasum as A

import _torch_port_pool as pool

WORLD = pool.WORLD


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "adasum")


@pytest.fixture(scope="module")
def inputs():
    return pool.part_inputs("adasum")


def _shard_map(body, axes, *args):
    devices = np.array(jax.devices()[:WORLD])
    if len(axes) == 2:
        devices = devices.reshape(2, 2)
    spec = P(axes if len(axes) == 2 else axes[0])
    f = jax.jit(shard_map(body, mesh=Mesh(devices, axes), in_specs=spec,
                          out_specs=spec, check_vma=False))
    return f(*args)


@pytest.fixture(scope="module")
def references(inputs):
    x, y = jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"])

    def flat(x_, y_):
        x_, y_ = x_[0], y_[0]
        return {"world": Aj.adasum_allreduce(x_, "data")[None],
                "world_y": Aj.adasum_allreduce(y_, "data")[None],
                "scaled": Cj.allreduce(x_, op=hvd_jax.Adasum,
                                       axis_name="data", prescale_factor=0.5,
                                       postscale_factor=3.0)[None]}

    def hier(x_, z_, t_):
        out = {}
        for key, v in (("hier", x_[0]), ("hier_z", z_[0])):
            out[f"{key}-None"] = Aj.adasum_allreduce_hierarchical(
                v, "local", "cross")[None]
            out[f"{key}-int8"] = Aj.adasum_allreduce_hierarchical(
                v, "local", "cross", spec=Qj.QuantSpec(8, 256))[None]
            out[f"{key}-bf16"] = Aj.adasum_allreduce_hierarchical(
                v, "local", "cross", wire_dtype=jnp.bfloat16)[None]
        out["hier_t-None"] = Aj.adasum_allreduce_hierarchical(
            t_[0], "local", "cross")[None]
        return out

    out = {k: np.asarray(v) for k, v in _shard_map(
        flat, ("data",), x, y).items()}
    out.update({k: np.asarray(v) for k, v in _shard_map(
        hier, ("cross", "local"), x, jnp.asarray(inputs["z"]),
        jnp.asarray(inputs["t"])).items()})
    out["world3"] = np.asarray(Aj.adasum_tree(x[:3]))
    return out


NAMES = ["world", "world_y", "scaled", "world3", "hier-None", "hier-int8",
         "hier-bf16", "hier_z-None", "hier_z-int8", "hier_z-bf16",
         "hier_t-None"]


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name", NAMES)
def test_adasum_matches_reference(ranks, references, inputs, name):
    """4 ranks: the VHDD ladder (against the reference's); 3: gather + tree
    (against ``adasum_tree``); 2 x 2: the hierarchical schedule, fp32 and
    on the int8 and bf16 intra-node wires, on x (1000 elements), z (1002:
    node shards of 501, odd) and t (10: shards of 5)."""
    n = 3 if name == "world3" else WORLD
    ref = references[name]
    big = np.abs(ref).max()
    wire = name.split("-")[-1]
    source = {"hier_z": "z", "hier_t": "t"}.get(name.split("-")[0], "x")
    # The intra-node wire rounds each node's contributions (two passes) and
    # the result once more: one grid step of the sum's magnitude.
    step = {"int8": np.abs(inputs[source]).max() * 2 / 127,
            "bf16": big * 2.0 ** -6}.get(wire, 1e-5 * big)
    for r in range(n):
        got = ranks[r][name].numpy()
        want = ref if name == "world3" else ref[r]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= step, (name, r,
                                                  np.abs(got - want).max())
        assert torch.equal(ranks[r][name], ranks[0][name])
    # Adasum is not the plain sum or mean of correlated contributions.
    plain = inputs["x"][:n].sum(0)
    if name.startswith("world") and name != "world_y":
        assert np.abs(ranks[0][name].numpy() - plain).max() > 1e-2 * big


@pytest.mark.timeout(150)
def test_adasum_group_and_errors(ranks):
    for res in ranks:
        x_red, y_red = res["grouped"]
        # Member by member: the coefficients are each tensor's own.
        assert torch.equal(x_red, res["world"])
        assert torch.equal(y_red, res["world_y"])
        assert "requires a (local, cross) axis_name pair" in \
            res["world_int8"]


@pytest.mark.timeout(150)
def test_delta_model_matches_reference(ranks, inputs):
    """DistributedOptimizer(SGD(0.1), op=Adasum): the inner step on each
    rank's gradient, then Adasum of the parameter delta, as the reference's
    ``DistributedOptimizer(optax.sgd(0.1), op=Adasum)``."""
    tx = hvd_jax.DistributedOptimizer(optax.sgd(0.1), op=hvd_jax.Adasum)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def step(g, s, p):
        u, s = tx.update(g[0], s, p)
        return optax.apply_updates(p, u), s

    f = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("data"), P(), P()),
                          out_specs=(P(), P()), check_vma=False))
    p = jnp.asarray(inputs["w"])
    state = tx.init(p)
    for s in range(2):
        p, state = f(jnp.asarray(inputs["g"][s]), state, p)
        for r in range(WORLD):
            np.testing.assert_allclose(ranks[r]["optimizer"][s].numpy(),
                                       np.asarray(p), rtol=0, atol=1e-6)
    assert not np.allclose(np.asarray(p), inputs["w"]
                           - 0.1 * inputs["g"].sum(1).sum(0), atol=1e-3)


@pytest.mark.timeout(150)
def test_delta_model_backward_passes_match_reference(ranks, inputs):
    """DistributedOptimizer(SGD(0.1), op=Adasum, backward_passes_per_step
    =2) on 2 ranks, 4 passes: the inner step on the scaled sum of each
    rank's passes, then Adasum of the delta, as the reference's
    ``DistributedOptimizer(optax.sgd(0.1), op=Adasum,
    backward_passes_per_step=2)``; the first pass of each pair leaves the
    parameters as they were."""
    tx = hvd_jax.DistributedOptimizer(optax.sgd(0.1), op=hvd_jax.Adasum,
                                      backward_passes_per_step=2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def run(gs, p):
        s, out = tx.init(p), []
        for q in range(4):
            u, s = tx.update(gs[q, 0], s, p)
            p = optax.apply_updates(p, u)
            out.append(p)
        return jnp.stack(out)

    g = inputs["g"]       # (2, 4, 50): pass q, rank r -> g[q//2, 2(q%2)+r]
    gs = np.stack([g[q // 2, 2 * (q % 2):2 * (q % 2) + 2]
                   for q in range(4)])
    want = jax.jit(shard_map(run, mesh=mesh, in_specs=(P(None, "data"), P()),
                             out_specs=P(), check_vma=False))(
        jnp.asarray(gs), jnp.asarray(inputs["w"]))
    for r in range(2):
        got = ranks[r]["bpps2"]
        for q in range(4):
            np.testing.assert_allclose(got[q].numpy(), np.asarray(want[q]),
                                       rtol=0, atol=1e-6)
        assert torch.equal(got[0], torch.from_numpy(inputs["w"]))
        assert torch.equal(got[2], got[1])
    # Summed and scaled, not the last pass alone.
    last_only = inputs["w"] - 0.1 * gs[1].mean(0)
    assert not np.allclose(np.asarray(want[1]), last_only, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_adasum_tree_matches_reference(n, dtype):
    rng = np.random.default_rng(n)
    stack = rng.standard_normal((n, 6, 50)).astype(np.float32)
    stack[1] = 0.0 if n > 2 else stack[1]     # a zero norm: coefficient 1
    stack[-1] += stack[0]                     # correlated
    ref = np.asarray(Aj.adasum_tree(jnp.asarray(stack).astype(
        getattr(jnp, dtype))).astype(jnp.float32))
    got = A.adasum_tree(torch.from_numpy(stack).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= (1e-6 if dtype == "float32" else 2.0 ** -8), rel


def test_adasum_pair_coefficients():
    """Parallel vectors average, orthogonal ones add, a zero one adds."""
    a = torch.tensor([1.0, 2.0, 0.0])
    torch.testing.assert_close(A.adasum_pair(a, a), a)
    b = torch.tensor([0.0, 0.0, 5.0])
    torch.testing.assert_close(A.adasum_pair(a, b), a + b)
    torch.testing.assert_close(A.adasum_pair(a, torch.zeros(3)), a)
    np.testing.assert_allclose(
        A.adasum_pair(a, 3 * a).numpy(),
        np.asarray(Aj.adasum_pair(jnp.asarray(a.numpy()),
                                  jnp.asarray(3 * a.numpy()))), rtol=1e-6)
