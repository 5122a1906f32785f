"""horovod_tpu_torch's negotiated device plane (``ops.eager``): the
executor on four gloo ranks with the native controller attached (started
once per test process by ``_torch_port_pool.part_results``, bodies in
``_torch_port_eager_workers``), the counterpart of the reference's
test_eager_device_plane.py and test_async_api.py.

Six float32 tensors enqueued before any wait are fused (the runtime's
``last_fused_names`` > 1) and equal per-tensor ``dist.all_reduce`` on the
world group within 4 fp32 ulps of each tensor's largest magnitude: a fused
buffer moves each element's offset, and gloo's ring sums the ranks in an
order that follows the offset (ROADMAP queue 3, "Bucketed = per tensor";
every rank holds the same bits).  ``DistributedOptimizer``'s gradients
under the controller, per parameter and bucketed, are held to the flat
plane's the same way.  The other collectives on the device plane equal the
host plane's bit for bit; integer Average floors, scale factors apply,
bfloat16 sums in bfloat16.  The coordinator's stamped int8 wire runs the
compressed two-pass allreduce on the executor's group and equals it on the
world group bit for bit, moving fewer bytes.  An executor refusing in
PREPARE on one rank fails the op on every rank at once, and the next op
succeeds.  ``EagerBucketQueue`` (buckets of several leaves as named
asynchronous allreduces, and numpy leaves donated to the host plane)
gives the per-tensor values under the same bound, and
``EagerGatherQueue`` reassembles ZeRO-3 parameter buckets from their
shards bit for bit; ``set_session_bucket_bytes`` is the first thing
``resolve_bucket_bytes`` reads."""

import numpy as np
import pytest
import torch

import _torch_port_eager_workers as workers
import _torch_port_pool as pool
from horovod_tpu_torch.ops import overlap as O
from horovod_tpu_torch.ops import quantization as Q

WORLD = pool.WORLD
FP32_ULP = 2.0 ** -23


def _within_4_ulps(got, want):
    bound = 4 * FP32_ULP * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound


@pytest.fixture(scope="module")
def eager(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "eager",
                             prepare=pool.write_ports(1))


def _inputs(rank):
    rng = np.random.default_rng(20 + rank)
    return [torch.from_numpy((rng.standard_normal(s) * 3).astype(np.float32))
            for s in workers.FUSE_SHAPES]


def test_executor_fuses_names_in_flight_together(eager):
    for r in range(WORLD):
        assert eager[r]["fused_names"] > 1
        before, after = eager[r]["fuse_stats"]
        fused = [n for n, c in after["names_per_response"].items()
                 if c > before["names_per_response"].get(n, 0) and n > 1]
        assert fused, after


@pytest.mark.parametrize("i", range(len(workers.FUSE_SHAPES)))
def test_fused_equals_per_tensor_allreduce_within_4_ulps(eager, i):
    for r in range(WORLD):
        assert torch.equal(eager[r]["fused"][i], eager[0]["fused"][i])
        _within_4_ulps(eager[r]["fused"][i], eager[r]["flat"][i])
    want = sum(_inputs(r)[i] for r in range(WORLD)) / WORLD
    _within_4_ulps(eager[0]["fused"][i], want)


def test_grouped_allreduce_is_one_joint_enqueue(eager):
    for i in range(3):
        want = sum(_inputs(r)[i] for r in range(WORLD))
        for r in range(WORLD):
            _within_4_ulps(eager[r]["grouped"][i], want)


@pytest.mark.parametrize("kind", ["allgather", "broadcast", "alltoall"])
def test_device_plane_equals_host_plane(eager, kind):
    for r in range(WORLD):
        dev, host = eager[r]["device"][kind], eager[r]["host"][kind]
        if kind == "alltoall":
            assert torch.equal(dev[0], host[0])
            assert dev[1].tolist() == host[1].tolist()
            assert dev[1].dtype == torch.int32
        else:
            assert torch.equal(dev, host)


def test_reductions_on_the_device_plane(eager):
    ins = [_inputs(r) for r in range(WORLD)]
    rs = [torch.from_numpy(workers.host_inputs(r)["rs"])
          for r in range(WORLD)]
    ints = sum(torch.arange(7) * (r + 3) for r in range(WORLD))
    for r in range(WORLD):
        d = eager[r]["device"]
        assert torch.equal(d["int_average"], ints // WORLD)
        assert d["int_average"].dtype == torch.int64
        _within_4_ulps(d["scaled"], 3.0 * sum(0.5 * x[1] for x in ins))
        assert torch.equal(d["max"], torch.stack([x[3] for x in ins]).amax(0))
        assert d["bf16"].dtype == torch.bfloat16
        torch.testing.assert_close(
            d["bf16"].float(), sum(x[4] for x in ins), atol=0.25, rtol=2e-2)
        _within_4_ulps(d["reducescatter"],
                       (sum(rs) / WORLD)[2 * r: 2 * r + 2])


def test_async_handle_polls_then_synchronizes(eager):
    want = sum(_inputs(r)[2] for r in range(WORLD)) / WORLD
    for r in range(WORLD):
        polled, got = eager[r]["async"]
        assert polled in (True, False)
        _within_4_ulps(got, want)


def test_stamped_int8_wire_is_the_compressed_allreduce(eager):
    n = workers.FUSE_SHAPES[0][0] * workers.FUSE_SHAPES[0][1]
    for r in range(WORLD):
        wire, raw, sent = eager[r]["int8_wire"]
        assert wire == "int8"
        assert raw == 4 * n
        assert sent == Q.wire_bytes(n, Q.QuantSpec(8, Q.DEFAULT_BLOCK))
        assert torch.equal(eager[r]["int8"], eager[r]["int8_flat"])


def test_executor_refusing_on_one_rank_fails_every_rank(eager):
    want = sum(_inputs(r)[3] for r in range(WORLD))
    for r in range(WORLD):
        assert "rank 1" in eager[r]["failure"] or \
            "refused on rank 1" in eager[r]["failure"]
        assert eager[r]["failure_s"] < 10.0
        _within_4_ulps(eager[r]["after_failure"], want)


@pytest.mark.parametrize("overlap", [False, True])
def test_distributed_optimizer_under_the_controller(eager, overlap):
    for r in range(WORLD):
        grads, flat, fused = eager[r]["optimizer"][overlap]
        assert fused > 1
        for g, f, g0 in zip(grads, flat, eager[0]["optimizer"][overlap][0]):
            assert torch.equal(g, g0)
            _within_4_ulps(g, f)


def test_eager_bucket_queue(eager):
    for r in range(WORLD):
        out, buckets, ratio = eager[r]["bucket_queue"]
        assert any(len(b) > 1 for b in buckets) and len(buckets) > 1
        assert 0.0 <= ratio <= 1.0
        for i, o in enumerate(out):
            assert torch.equal(o, eager[0]["bucket_queue"][0][i])
            _within_4_ulps(o, eager[r]["flat"][i])
        donated, in_place = eager[r]["donated"]
        assert in_place
        for i, d in enumerate(donated):
            _within_4_ulps(d, eager[r]["flat"][i])


def test_eager_gather_queue(eager):
    for r in range(WORLD):
        full, params, buckets, seconds = eager[r]["gather_queue"]
        assert any(len(b) > 1 for b in buckets) and seconds > 0
        for f, p in zip(full, params):
            assert torch.equal(f, p)


@pytest.mark.parametrize("session,overlap,want", [
    (None, None, None), (None, True, 8 * 1024 * 1024), (0, None, None),
    (4096, None, 4096), (4096, True, 4096), (4096, False, None),
    (4096, 1024, 1024)])
def test_session_bucket_bytes(monkeypatch, session, overlap, want):
    for knob in ("HVD_TPU_OVERLAP", "HOROVOD_OVERLAP",
                 "HVD_TPU_OVERLAP_BUCKET_BYTES",
                 "HOROVOD_OVERLAP_BUCKET_BYTES"):
        monkeypatch.delenv(knob, raising=False)
    O.set_session_bucket_bytes(session)
    try:
        assert O.session_bucket_bytes() == session
        assert O.resolve_bucket_bytes(overlap) == want
    finally:
        O.set_session_bucket_bytes(None)
