"""horovod_tpu_torch's bucketed schedules (``ops/overlap.py``) against the
per-tensor ones and against horovod_tpu's, on four gloo ranks (a 2 x 2
cross x local topology, ranks 0-1 also in a world of two; started once
per test process by ``_torch_port_pool.part_results``).

* ``plan_buckets`` gives the reference's buckets on the same leaf shapes
  and dtypes, in both orders, at several bounds.
* Bucketed allreduce and reduce-scatter equal the per-tensor calls bit for
  bit on the bf16, int8 and int4 wires (every leaf padded to the block, so
  every element meets the same arithmetic), over the world and over
  ``("local", "cross")``.  On the uncompressed wire the sum is the
  backend's (gloo's ring), whose order follows the element's offset in
  the buffer: bit for bit at two ranks, within 4 fp32 ulps of the
  largest magnitude at four.  Against the reference's compiled schedules
  on the same inputs: within one grid step of the wire (its compiled
  quantizer multiplies by 1/qmax where the port divides), and at least
  99.9% of the fp32 elements within 1e-6 of the largest magnitude; the
  bf16 leaf within a bf16 step of it (gloo sums bf16 in bf16, XLA
  rounds once).
* ``DistributedOptimizer(overlap=…)`` with real backward passes (hooks)
  equals the per-parameter schedule bit for bit at two ranks — parameters
  and error-feedback residuals, every wire, bpps 1 and 2 — and its hooks
  launch every bucket in the communicating pass' backward and none in
  the others; ``grad(overlap=…)`` equals ``grad()``.
* ``gather_in_forward`` rebuilds the parameters exactly and its backward
  leaves the reference's shard gradients (fp32 within 1e-6; on the int8
  wire, gather and reduce-scatter, within one grid step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd_jax
from horovod_tpu.compat import shard_map
from horovod_tpu.ops import overlap as Oj
from horovod_tpu_torch.ops import overlap as O

import _torch_port_pool as pool

WORLD = pool.WORLD
COMP = {"none": None, "bf16": hvd_jax.Compression.bf16,
        "int8": hvd_jax.Compression.int8, "int4": hvd_jax.Compression.int4}
QMAX = {"int8": 127, "int4": 7}
FP32_ULP = 2.0 ** -23

# The flagship's parameters in the port's order (embed, pos, final_norm,
# then the layer tensors by name: ln1 ln2 w1 w2 wo wqkv) and a mixed-dtype
# list.
FLAGSHIP = [((8192, 512), "float32"), ((512, 512), "float32"),
            ((512,), "float32"), ((1, 8, 512), "float32"),
            ((1, 8, 512), "float32"), ((1, 8, 512, 2048), "float32"),
            ((1, 8, 2048, 512), "float32"), ((1, 8, 512, 512), "float32"),
            ((1, 8, 512, 1536), "float32")]
MIXED = [((300,), "float32"), ((40, 10), "bfloat16"), ((7,), "bfloat16"),
         ((1000,), "float32"), ((3, 3), "float32"), ((2000,), "bfloat16")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "overlap")


@pytest.fixture(scope="module")
def inputs():
    return pool.part_inputs("overlap")


@pytest.mark.parametrize("bucket_bytes", [None, 1 << 20, 4096, 64])
@pytest.mark.parametrize("order", ["backward", "forward"])
@pytest.mark.parametrize("leaves", [FLAGSHIP, MIXED],
                         ids=["flagship", "mixed"])
def test_plan_buckets_matches_reference(leaves, order, bucket_bytes):
    np_leaves = [np.broadcast_to(np.zeros((), getattr(jnp, dt)), shape)
                 for shape, dt in leaves]
    t_leaves = [torch.empty(shape, dtype=getattr(torch, dt), device="meta")
                for shape, dt in leaves]
    ref = Oj.plan_buckets(np_leaves, bucket_bytes, record=False, order=order)
    got = O.plan_buckets(t_leaves, bucket_bytes, order=order)
    assert got.buckets == ref.buckets
    assert (got.bucket_bytes, got.n_leaves) == (ref.bucket_bytes,
                                                ref.n_leaves)
    if leaves is FLAGSHIP and bucket_bytes is None and order == "backward":
        # [wqkv] [wo] [w2] [w1] [ln2 ln1 final_norm pos] [embed]
        assert got.buckets == ((8,), (7,), (6,), (5,), (4, 3, 2, 1), (0,))


@pytest.mark.parametrize("env,overlap,expected", [
    ({}, None, None), ({}, True, 8 << 20), ({}, False, None), ({}, 0, None),
    ({}, 4096, 4096), ({"HVD_TPU_OVERLAP": "1"}, None, 8 << 20),
    ({"HVD_TPU_OVERLAP": "on", "HOROVOD_OVERLAP_BUCKET_BYTES": "100"}, None,
     1024),
    ({"HVD_TPU_OVERLAP_BUCKET_BYTES": "65536"}, True, 65536)])
def test_resolve_bucket_bytes_matches_reference(monkeypatch, env, overlap,
                                                expected):
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        for knob in ("OVERLAP", "OVERLAP_BUCKET_BYTES"):
            monkeypatch.delenv(prefix + knob, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # The reference reads its session's config when it has one: make it
    # read the environment.
    from horovod_tpu.core.state import global_state
    monkeypatch.setattr(global_state, "config", None, raising=False)
    assert O.resolve_bucket_bytes(overlap) == expected
    assert Oj.resolve_bucket_bytes(overlap, compiled=True) == expected


CASES = [f"allreduce-{w}-{op}" for w in COMP for op in ("average", "sum")] \
    + [f"reducescatter-{w}" for w in COMP]


def _assert_same(per, bucketed, exact, label):
    for i, (a, b) in enumerate(zip(per, bucketed)):
        assert a.dtype == b.dtype and a.shape == b.shape, (label, i)
        if exact:
            assert torch.equal(a, b), (label, i, (a - b).abs().max())
        else:
            bound = 4 * FP32_ULP * a.abs().max().item() if \
                a.dtype == torch.float32 else 2.0 ** -7 * a.abs().max().item()
            assert (a.float() - b.float()).abs().max().item() <= bound, \
                (label, i)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name", CASES)
def test_bucketed_equals_per_leaf(ranks, name):
    wire = name.split("-")[1]
    for r, res in enumerate(ranks):
        _assert_same(*res["world"][name], wire != "none", (name, r))
        if r < 2 and wire == "none":
            _assert_same(*res["world2"][name], True, (name, r, "world 2"))
        if name in res["joint"]:
            _assert_same(*res["joint"][name], wire != "none",
                         (name, r, "joint"))


def _reference(inputs, axes, body):
    """``body(leaves)`` per rank under one jitted shard_map over ``axes``
    ("data" on 4 devices, or ("cross", "local") 2 x 2); returns per rank
    the list of results."""
    devices = np.array(jax.devices()[:WORLD])
    if len(axes) == 2:
        devices = devices.reshape(2, 2)
    spec = P(axes if len(axes) == 2 else axes[0])
    leaves = [jnp.asarray(inputs[f"leaf{i}"]).astype(
        jnp.bfloat16 if i == pool.BF16_LEAF else jnp.float32)
        for i in range(len(pool.LEAF_SHAPES))]

    def per_rank(ls):
        out = body([x[0] for x in ls])
        return {k: [v[None] for v in vs] for k, vs in out.items()}

    f = jax.jit(shard_map(per_rank, mesh=Mesh(devices, axes), in_specs=spec,
                          out_specs=spec, check_vma=False))
    out = f(leaves)
    return {k: [[np.asarray(v[r].astype(jnp.float32)) for v in vs]
                for r in range(WORLD)] for k, vs in out.items()}


@pytest.fixture(scope="module")
def references(inputs):
    def flat(ls):
        out = {}
        for w, comp in COMP.items():
            out[f"allreduce-{w}-average"] = Oj.bucketed_allreduce_tree(
                ls, hvd_jax.Average, "data", comp, bucket_bytes=4096)
            out[f"allreduce-{w}-sum"] = Oj.bucketed_allreduce_tree(
                ls, hvd_jax.Sum, "data", comp, 0.5, 3.0, bucket_bytes=4096)
            out[f"reducescatter-{w}"] = Oj.bucketed_reducescatter_tree(
                ls, hvd_jax.Average, "data", comp, bucket_bytes=4096)
        return out

    def joint(ls):
        return {f"reducescatter-{w}": Oj.bucketed_reducescatter_tree(
            ls, hvd_jax.Average, ("local", "cross"), COMP[w],
            bucket_bytes=4096) for w in ("none", "int8")}

    return {"world": _reference(inputs, ("data",), flat),
            "joint": _reference(inputs, ("cross", "local"), joint)}


def _assert_near(got, ref, wire, label):
    big = max(np.abs(x).max() for x in ref)
    step = big / QMAX[wire] if wire in QMAX else \
        big * (2.0 ** -7 if wire == "bf16" else 1e-5)
    for i, (g, x) in enumerate(zip(got, ref)):
        g = g.float().numpy()
        diff = np.abs(g - x)
        bf16 = i == pool.BF16_LEAF
        assert diff.max() <= max(step, big * 2.0 ** -7 if bf16 else 0), \
            (label, i, diff.max(), step)
        if not bf16:
            assert (diff <= 1e-6 * big).mean() >= 0.999, (label, i)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("name", CASES)
def test_bucketed_matches_reference(ranks, references, name):
    wire = name.split("-")[1]
    for r, res in enumerate(ranks):
        _assert_near(res["world"][name][1], references["world"][name][r],
                     wire, (name, r))
        if name in references["joint"]:
            _assert_near(res["joint"][name][1], references["joint"][name][r],
                         wire, (name, r, "joint"))


@pytest.mark.timeout(150)
@pytest.mark.parametrize("wire", list(COMP))
@pytest.mark.parametrize("bpps", [1, 2])
def test_optimizer_overlap_equals_per_parameter(ranks, wire, bpps):
    for r in range(2):
        opt = ranks[r]["optimizer"]
        per, ov = opt[f"{wire}-bpps{bpps}-False"], opt[f"{wire}-bpps{bpps}-True"]
        for s, (a, b) in enumerate(zip(per, ov)):
            communicates = (s + 1) % bpps == 0
            for x, y in zip(a["params"], b["params"]):
                assert torch.equal(x, y), (r, s)
            if wire in QMAX:
                for x, y in zip(a["residual"], b["residual"]):
                    assert torch.equal(x, y), (r, s)
                assert any(x.abs().max() > 0 for x in b["residual"]) == \
                    (s + 1 >= bpps)
            else:
                assert a["residual"] is None and b["residual"] is None
            # Five parameters at 2 KiB: [ps4 ps3] [ps2] [ps1] [ps0].
            assert sorted(b["launched"]) == ([0, 1, 2, 3] if communicates
                                             else []), (s, b["launched"])
        assert not torch.equal(per[-1]["params"][0], per[0]["params"][0])


@pytest.mark.timeout(150)
def test_grad_overlap_equals_grad(ranks):
    for r, res in enumerate(ranks):
        for comp in ("None", "int8"):
            plain, ov = res["grad4"][f"{comp}-None"], \
                res["grad4"][f"{comp}-2048"]
            _assert_same(plain, ov, comp == "int8", (r, comp))
            if r < 2:
                _assert_same(res["grad2"][f"{comp}-None"],
                             res["grad2"][f"{comp}-2048"], True, (r, comp))
    for k in ranks[0]["grad4"]:
        for a, b in zip(ranks[0]["grad4"][k], ranks[3]["grad4"][k]):
            assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def gather_references(inputs):
    params = [jnp.asarray(inputs[f"param{i}"])
              for i in range(len(pool.GATHER_SHAPES))]
    cts = [jnp.asarray(inputs[f"ct{i}"]) for i in range(len(params))]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def rows(p):
        flat = p.reshape(-1)
        flat = jnp.pad(flat, (0, (-flat.size) % WORLD))
        return flat.reshape(WORLD, -1)

    out = {}
    for label, kw in (("plain", {}),
                      ("int8", dict(compression=hvd_jax.Compression.int8,
                                    quantize_gather=True))):
        def per_rank(shards, cs):
            shards, cs = [s[0] for s in shards], [c[0] for c in cs]

            def fwd(ss):
                return Oj.gather_in_forward(ss, params, axis_name="data",
                                            bucket_bytes=1024, **kw)
            full, vjp = jax.vjp(fwd, shards)
            (grads,) = vjp(cs)
            return [f[None] for f in full], [g[None] for g in grads]

        shards = [jnp.stack([rows(p)[r] for r in range(WORLD)])
                  for p in params]
        f = jax.jit(shard_map(per_rank, mesh=mesh,
                              in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data")),
                              check_vma=False))
        full, grads = f(shards, cts)
        out[label] = ([np.asarray(x) for x in full],
                      [np.asarray(g) for g in grads])
    return out


@pytest.mark.timeout(150)
@pytest.mark.parametrize("label", ["plain", "int8"])
def test_gather_in_forward_matches_reference(ranks, inputs,
                                             gather_references, label):
    ref_full, ref_grads = gather_references[label]
    for r, res in enumerate(ranks):
        full, grads = res[f"gather-{label}"]
        for i, f in enumerate(full):
            p = inputs[f"param{i}"]
            if label == "plain":   # a gather moves values, exactly
                np.testing.assert_array_equal(f.numpy(), p)
            else:
                step = np.abs(p).max() / 127
                assert np.abs(f.numpy() - ref_full[i][r]).max() <= step
            ct = inputs[f"ct{i}"]
            step = np.abs(ct).max() / 127 if label == "int8" else 1e-6
            assert np.abs(grads[i].numpy() - ref_grads[i][r]).max() <= \
                step, (label, r, i)
            if label == "plain":   # the mean of the ranks' cotangents
                mean = O._rows_of(torch.from_numpy(ct.mean(0)), WORLD)[r]
                torch.testing.assert_close(grads[i], mean, rtol=0,
                                           atol=1e-6)


@pytest.mark.parametrize("case", ["distributed", "distributed-bpps2",
                                  "zero1"])
def test_second_backward_before_step_raises(case):
    """With hooks, a second backward before ``step()`` raises Horovod's
    error: its buckets left with the first pass' gradients, so a silent
    accumulation would be lost.  At bpps 2 the passes before the
    communicating one accumulate locally and do not count."""
    import functools
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.ones(3))
        sgd = functools.partial(torch.optim.SGD, lr=0.1)
        if case == "zero1":
            opt = hvd.ZeroShardedOptimizer([w], sgd, stage=1, overlap=True)
        else:
            opt = hvd.DistributedOptimizer(
                sgd([w]), overlap=True,
                backward_passes_per_step=2 if case.endswith("2") else 1)
        if case.endswith("2"):
            (w * 2).sum().backward()
            opt.step()                      # accumulates, no update
            torch.testing.assert_close(w.detach(), torch.ones(3))
        (w * 2).sum().backward()
        with pytest.raises(RuntimeError, match="backward_passes_per_step"):
            (w * 3).sum().backward()
    finally:
        hvd.shutdown()
