"""horovod_tpu_torch's mesh helpers (``parallel.mesh``) and the runtime's
``mesh()`` / ``is_homogeneous()`` against horovod_tpu's, in one process
(world 1 over gloo).  The reference's mesh holds devices and the port's
ranks, so sizes are compared where the worlds agree and names and errors
everywhere; the four-rank layout is held in test_torch_port_gspmd.py."""

import jax
import pytest

from horovod_tpu.core import basics as basics_jax
from horovod_tpu.core import state as state_jax
from horovod_tpu.core.config import Config
from horovod_tpu.parallel import mesh as mesh_jax

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.parallel import mesh as mesh_lib


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_axis_names_are_the_reference_s():
    for name in ("DATA", "FSDP", "TENSOR", "SEQUENCE", "PIPELINE", "EXPERT"):
        assert getattr(mesh_lib, name) == getattr(mesh_jax, name)
    assert hvd.parallel.DATA == "data"


@pytest.mark.parametrize("spec", ["data:8,model:4", "data:1", " seq : 2 ,",
                                  "", "a:1,b:2,c:3"])
def test_parse_mesh_spec(spec):
    assert mesh_lib.parse_mesh_spec(spec) == mesh_jax.parse_mesh_spec(spec)


@pytest.mark.parametrize("shape", [{"data": 1}, {"data": 1, "model": 1},
                                   {"seq": 1, "data": 1, "pipe": 1}])
def test_create_mesh_matches_reference(world1, shape):
    mine = mesh_lib.create_mesh(shape)
    ref = mesh_jax.create_mesh(shape, devices=jax.devices()[:1])
    assert mesh_lib.local_mesh_axes(mine) == mesh_jax.local_mesh_axes(ref)
    for name in shape:
        assert mesh_lib.axis_size(mine, name) == mesh_jax.axis_size(ref, name)
    assert mine.device_type == "cpu"


@pytest.mark.parametrize("shape", [{"data": 2}, {"data": 1, "model": 3}])
def test_create_mesh_refuses_too_many_slots(world1, shape):
    with pytest.raises(ValueError) as mine:
        mesh_lib.create_mesh(shape)
    with pytest.raises(ValueError) as ref:
        mesh_jax.create_mesh(shape, devices=jax.devices()[:1])
    assert str(mine.value) == str(ref.value)


def test_data_parallel_mesh(world1):
    m = mesh_lib.data_parallel_mesh()
    assert m.mesh_dim_names == ("data",) and m.mesh.tolist() == [0]


def test_mesh_needs_init():
    with pytest.raises(hvd.NotInitializedError):
        hvd.mesh()
    with pytest.raises(hvd.NotInitializedError):
        mesh_lib.create_mesh({"data": 1})


@pytest.mark.parametrize("spec,axes", [(None, None), ("model:1,data:1", None),
                                       ("model:1,data:1", ("data",))])
def test_default_mesh_matches_reference(monkeypatch, spec, axes):
    """The knob's mesh unless axes were given (the reference reads the
    hint only to skip the knob); else 1-D "data" over the world."""
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        monkeypatch.delenv(prefix + "MESH_AXES", raising=False)
    if spec is not None:
        monkeypatch.setenv("HVD_TPU_MESH_AXES", spec)
    old = state_jax.global_state.config
    state_jax.global_state.config = Config.from_env()
    if spec is not None:    # the reference's devices: 8 CPU devices here
        state_jax.global_state.config.mesh_axes = "model:2,data:4"
    try:
        ref = basics_jax._build_default_mesh(axes)
    finally:
        state_jax.global_state.config = old
    hvd.init(device="cpu", axes=axes)
    try:
        assert global_state.mesh is None          # built on first use
        m = hvd.mesh()
        assert hvd.mesh() is m
        assert m.mesh_dim_names == tuple(ref.axis_names)
        assert m.mesh.numel() == 1
    finally:
        hvd.shutdown()
    assert global_state.mesh is None


def test_init_takes_a_mesh():
    hvd.init(device="cpu")
    try:
        m = mesh_lib.create_mesh({"seq": 1})
    finally:
        hvd.shutdown()
    hvd.init(device="cpu", mesh=m)
    try:
        assert hvd.mesh() is m
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("size,cross", [(1, 1), (4, 2), (6, 4), (8, 3)])
def test_is_homogeneous_matches_reference(world1, size, cross):
    old = (state_jax.global_state.initialized, state_jax.global_state.size,
           state_jax.global_state.cross_size)
    state_jax.global_state.initialized = True
    state_jax.global_state.size, state_jax.global_state.cross_size = \
        size, cross
    global_state.size, global_state.cross_size = size, cross
    try:
        assert hvd.is_homogeneous() == basics_jax.is_homogeneous()
    finally:
        (state_jax.global_state.initialized, state_jax.global_state.size,
         state_jax.global_state.cross_size) = old
    assert hvd.is_homogeneous() == (size % cross == 0)
