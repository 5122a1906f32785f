"""The port's launcher units against the reference's (horovod_tpu/runner/)
on the same inputs: the per-slot platform plan (mode and device indices),
``wrap_python_command``, ``parse_args``/``knob_env``, the NIC probe, the
fn-shipping protocol, GPU discovery against TPU discovery, the torch
world's env and bootstrap, and ``init()``'s device choice and CPU slots.
No worker process is launched here (test_torch_port_launch_e2e.py and
…_launch_ssh.py launch them)."""

import json
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from horovod_tpu.runner import chips as ref_chips
from horovod_tpu.runner import fnpickle as ref_fnpickle
from horovod_tpu.runner import launch as ref_launch
from horovod_tpu.runner import probe as ref_probe
from horovod_tpu.runner import tpu_discovery as ref_discovery
from horovod_tpu_torch.runner import bootstrap, chips, fnpickle
from horovod_tpu_torch.runner import gpu_discovery, launch, probe
from horovod_tpu_torch.runner.hosts import (HostInfo as H,
                                            get_host_assignments, parse_hosts)

PORT_POLICY = {"auto": "auto", "cpu": "cpu", "tpu": "gpu"}


# --- the plan -------------------------------------------------------------

@pytest.mark.parametrize("policy", sorted(PORT_POLICY))
@pytest.mark.parametrize("n_chips", [1, 2, 4, 8])
def test_plan_matches_reference(n_chips, policy):
    """For every local size 1-8 the port decides the reference's mode, and
    each partitioned slot's CUDA_VISIBLE_DEVICES lists the reference
    slot's TPU_VISIBLE_DEVICES; a CPU slot is pinned in both."""
    for local_size in range(1, 9):
        ref = ref_chips.plan_host_platform(
            local_size, policy, chips=n_chips, partitionable=True,
            cpu_jax_world=False)
        got = chips.plan_host_platform(
            local_size, PORT_POLICY[policy], chips=n_chips,
            partitionable=True)
        assert got.mode == ref.mode, (n_chips, policy, local_size)
        for i in range(local_size):
            r_env = ref.slot_env(i, local_size)
            p_env = got.slot_env(i, local_size)
            if ref.mode == "partition":
                assert (p_env["CUDA_VISIBLE_DEVICES"]
                        == r_env["TPU_VISIBLE_DEVICES"]), (i, local_size)
                assert p_env[chips.PARTITION_ENV] == f"{i}/{local_size}"
            elif ref.mode == "cpu":
                assert r_env["HVD_TPU_WORKER_PLATFORM"] == "cpu"
                assert p_env == {"HVD_TPU_WORKER_PLATFORM": "cpu",
                                 "CUDA_VISIBLE_DEVICES": ""}
            else:
                assert p_env == r_env == {}


def test_plan_partitions_by_divisibility():
    """The documented difference: a GPU host has no ICI grid, so 6 cards
    split among 2 or 3 workers (the reference has no 6-chip grid and pins
    them to the CPU), and the split follows the launcher's own card
    names."""
    for local_size in (2, 3):
        assert ref_chips.plan_host_platform(
            local_size, chips=6, partitionable=True,
            cpu_jax_world=False).mode == "cpu"
        plan = chips.plan_host_platform(local_size, chips=6,
                                        partitionable=True)
        assert plan.mode == "partition"
    plan = chips.plan_host_platform(2, chips=4, partitionable=True,
                                    devices=["4", "5", "6", "7"])
    assert [plan.slot_env(i, 2)["CUDA_VISIBLE_DEVICES"]
            for i in range(2)] == ["4,5", "6,7"]
    assert chips.plan_host_platform(3, chips=4,
                                    partitionable=True).reason == \
        "4 card(s) do not split among 3 workers"
    assert chips.plan_host_platform(2, chips=-1,
                                    partitionable=False).mode == "cpu"
    with pytest.raises(ValueError, match="tpu"):
        chips.plan_host_platform(2, "tpu")


# --- one backend a world -------------------------------------------------

@pytest.mark.parametrize("np_,hosts,cards,want", [
    (3, "a:2,b:2", "2", {"a": ("0", "1"), "b": (None,)}),
    (4, "a:2,b:2", "2", {"a": ("0", "1"), "b": ("0", "1")}),
    (6, "a:3,b:3", "2", {"a": ("",) * 3, "b": ("",) * 3}),
    (7, "a:4,b:4", "4", ["b"]),
    (3, "a:2,b:2", "1", ["a"]),
])
def test_a_static_world_runs_one_backend(monkeypatch, capsys, np_, hosts,
                                         cards, want):
    """Each slot's CUDA_VISIBLE_DEVICES (None: the host's view inherited,
    "": pinned to the CPU); a plan that pins some hosts' slots to the CPU
    while others compute on cards is refused, naming the pinned hosts
    and the flag that settles it."""
    from horovod_tpu_torch.runner import exec as exec_t
    monkeypatch.setenv("HVD_TPU_CHIPS_PER_HOST", cards)
    slots = get_host_assignments(parse_hosts(hosts), np_)
    if isinstance(want, list):
        with pytest.raises(ValueError) as e:
            exec_t.plan_hosts(slots, "auto")
        assert f"host(s) {want} would pin their slots to the CPU" in \
            str(e.value) and "--worker-platform cpu" in str(e.value)
        return
    plans = exec_t.plan_hosts(slots, "auto")
    got = {}
    for s in slots:
        env = plans[s.hostname].slot_env(s.local_rank, s.local_size)
        got[s.hostname] = got.get(s.hostname, ()) + (
            env.get("CUDA_VISIBLE_DEVICES"),)
    assert got == want
    pinned = capsys.readouterr().err
    assert ("pinned to the CPU" in pinned) == ("" in want["a"])


def test_launch_refuses_a_mixed_world_before_it_starts(monkeypatch,
                                                       capsys):
    """-np 7 -H a:4,b:4 on 4-card hosts: b's 3 slots do not split its
    cards; the launcher exits 2 before it probes or reaches any host."""
    from horovod_tpu_torch.runner import exec as exec_t
    monkeypatch.setenv("HVD_TPU_CHIPS_PER_HOST", "4")
    monkeypatch.setattr(launch, "start_rendezvous", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(exec_t.subprocess, "Popen", lambda *a, **k: 1 / 0)
    assert launch.main(["-np", "7", "-H", "a:4,b:4", "python",
                        "x.py"]) == 2
    err = capsys.readouterr().err
    assert "host(s) ['b'] would pin" in err and \
        "4 card(s) do not split among 3 workers" in err
    assert launch.main(["-np", "7", "-H", "a:4,b:4", "--worker-platform",
                        "gpu", "--check-build"]) == 0


@pytest.fixture
def elastic_driver():
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    driver = ElasticDriver(FixedHosts([]), ["true"], min_np=1, max_np=None)
    yield driver
    driver._rendezvous.stop()


class _Live:
    def poll(self):
        return None


def test_elastic_grow_keeps_each_slot_on_its_own_card(monkeypatch,
                                                      elastic_driver):
    """An elastic host of 4 cards grows 2 → 3 → 4 slots: every slot is
    spawned once, on the card of its index, and no two share one (a
    per-round partition would give the new slot 2 of 4 the card 2 that
    survivor 1 of 2 holds in "2,3"); a fifth slot has no card and its
    round is refused, ending the job."""
    from horovod_tpu_torch.runner import exec as exec_t
    monkeypatch.setenv("HVD_TPU_CHIPS_PER_HOST", "4")
    spawned = {}

    def launch_workers(slots, command, controller_addr, extra_env=None,
                       platform_policy="auto", **kw):
        assert platform_policy is None
        (s,) = slots
        spawned[f"{s.hostname}:{s.local_rank}"] = (
            extra_env.get("CUDA_VISIBLE_DEVICES"),
            extra_env.get(chips.PARTITION_ENV))
        return [exec_t.WorkerProcess(s, _Live())]

    monkeypatch.setattr(exec_t, "launch_workers", launch_workers)
    for n in (2, 3, 4):
        elastic_driver._start_round([H("a", n)])
    assert spawned == {f"a:{i}": (str(i), f"{i}/4") for i in range(4)}
    assert elastic_driver._result is None
    elastic_driver._start_round([H("a", 5)])
    assert elastic_driver._result == 1 and len(spawned) == 4


@pytest.mark.parametrize("cards,policy,want", [
    ({"a": (2, ["6", "7"]), "b": (1, None)}, "auto",
     {"a:0": "6", "a:1": "7", "b:0": "0"}),
    ({"a": (0, None), "b": (0, None)}, "auto",
     {"a:0": "", "a:1": "", "b:0": ""}),
    ({"a": (2, None), "b": (-1, None)}, "auto",
     {"a:0": "0", "a:1": "1", "b:0": None}),
    ({"a": (2, None), "b": (0, None)}, "auto", "['b'] would pin"),
    ({"a": (1, None), "b": (1, None)}, "auto", "a (1 card(s), slot 1)"),
    ({"a": (1, None), "b": (1, None)}, "gpu",
     {"a:0": None, "a:1": None, "b:0": None}),
    ({"a": (2, None), "b": (1, None)}, "cpu",
     {"a:0": "", "a:1": "", "b:0": ""}),
])
def test_elastic_round_plan(elastic_driver, cards, policy, want):
    """Each elastic slot's card (None: inherited, "": pinned to the
    CPU); a round that would not run one backend is refused."""
    elastic_driver._cards = dict(cards)
    elastic_driver._platform_policy = policy
    slots = get_host_assignments([H("a", 2), H("b", 1)], 3)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=re.escape(want)):
            elastic_driver._plan_round(slots)
        return
    envs = elastic_driver._plan_round(slots)
    assert {sid: env.get("CUDA_VISIBLE_DEVICES")
            for sid, env in envs.items()} == want


@pytest.mark.parametrize("command", [
    ["python", "train.py", "--lr", "0.1"],
    ["python3", "-u", "train.py"],
    ["python3.12", "-W", "ignore", "-X", "dev", "-O", "train.py", "-x"],
    ["/usr/bin/python3", "-m", "pkg.mod", "--flag"],
    ["python", "-c", "print(1)", "a"],
    ["pypy", "x.py"],
    ["bash", "run.sh"],
    [],
])
def test_wrap_python_command_matches_reference(command):
    ref = ref_chips.wrap_python_command(command)
    got = chips.wrap_python_command(command)
    assert got == [("horovod_tpu_torch.runner.bootstrap"
                    if c == "horovod_tpu.runner.bootstrap" else c)
                   for c in ref]


def test_torch_world_env(monkeypatch):
    local = get_host_assignments(parse_hosts("localhost:2"), 2)
    env = chips.torch_world_env(local)
    assert env["MASTER_ADDR"] == "127.0.0.1"
    assert 0 < int(env["MASTER_PORT"]) < 65536
    assert not chips.needs_bootstrap(env)
    mixed = get_host_assignments(parse_hosts("localhost:1,10.9.8.7:1"), 2)
    assert chips.torch_world_env(mixed, "10.0.0.5:4000")["MASTER_ADDR"] \
        == "10.0.0.5"
    remote0 = get_host_assignments(parse_hosts("10.9.8.7:1,localhost:1"), 2)
    env = chips.torch_world_env(remote0, "10.0.0.5:4000")
    assert env == {"MASTER_ADDR": "10.9.8.7", "MASTER_PORT": "auto"}
    assert chips.needs_bootstrap(env)
    with pytest.raises(ValueError, match="rendezvous"):
        chips.torch_world_env(remote0)


def test_bootstrap_resolves_a_remote_rank0_port(monkeypatch, tmp_path):
    """MASTER_PORT=auto: rank 0 publishes a port through the signed KV,
    a peer reads it, and bootstrap.main runs the script after it."""
    from horovod_tpu_torch.runner.rendezvous import (RendezvousServer,
                                                     generate_secret)
    secret = generate_secret()
    server = RendezvousServer(host="127.0.0.1", secret=secret)
    port = server.start()
    try:
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", f"127.0.0.1:{port}")
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", secret)
        monkeypatch.setenv("MASTER_PORT", "auto")
        monkeypatch.setenv("HVD_TPU_RANK", "0")
        bootstrap.apply_torch_world()
        published = os.environ["MASTER_PORT"]
        assert published.isdigit()
        assert server.get("global", bootstrap.WORLD_PORT_KEY) == \
            published.encode()
        monkeypatch.setenv("MASTER_PORT", "auto")
        monkeypatch.setenv("HVD_TPU_RANK", "1")
        monkeypatch.setattr(sys, "argv", list(sys.argv))  # main() sets it
        out = tmp_path / "port"
        script = tmp_path / "s.py"
        script.write_text("import os, sys\n"
                          "open(sys.argv[1], 'w').write("
                          "os.environ['MASTER_PORT'])\n")
        assert bootstrap.main(["--", str(script), str(out)]) == 0
        assert out.read_text() == published
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", "wrong")
        monkeypatch.setenv("MASTER_PORT", "auto")
        with pytest.raises(SystemExit):
            bootstrap.main(["-c", "pass"])
    finally:
        server.stop()


# --- the CLI's flags ------------------------------------------------------

FLAG_SETS = [
    # tests/test_launch_flags.py:34-58
    ["-np", "1", "--disable-cache", "--hierarchical-allreduce",
     "--hierarchical-allgather", "--start-timeout", "30",
     "--elastic-timeout", "120", "--network-interface", "lo",
     "--autotune", "--autotune-warmup-samples", "5",
     "--autotune-steps-per-sample", "10",
     "--autotune-bayes-opt-max-samples", "40",
     "--autotune-gaussian-process-noise", "0.5", "python", "x.py"],
    ["-np", "1", "--log-hide-timestamp", "python", "x"],
    # tests/test_runner.py:187-199
    ["-np", "1", "--fusion-threshold-mb", "32", "--cycle-time-ms", "2.5",
     "--timeline-filename", "/tmp/tl.json", "--autotune",
     "--no-stall-check", "python", "x.py"],
    ["-np", "2", "--cache-capacity", "64", "--timeline-mark-cycles",
     "--stall-check-warning-time-seconds", "5",
     "--stall-check-shutdown-time-seconds", "9", "--log-level", "DEBUG",
     "--autotune-log-file", "/tmp/at.csv", "--gloo", "--tcp", "--",
     "python", "-u", "x.py"],
]


@pytest.mark.parametrize("argv", FLAG_SETS, ids=range(len(FLAG_SETS)))
def test_knob_env_and_parse_args_match_reference(argv):
    ref, got = ref_launch.parse_args(argv), launch.parse_args(argv)
    assert got.command == ref.command
    assert launch.knob_env(got) == ref_launch.knob_env(ref)
    common = set(vars(ref)) & set(vars(got))
    assert {k: getattr(got, k) for k in common} == \
        {k: getattr(ref, k) for k in common}


def test_parse_args_rejections_and_config(tmp_path):
    for flag in ("--mpi", "--jsrun"):
        with pytest.raises(SystemExit):
            launch.parse_args([flag, "-np", "1", "python", "x.py"])
    with pytest.raises(SystemExit):
        launch.parse_args(["-np", "1"])
    with pytest.raises(SystemExit):   # the reference's "tpu" is "gpu" here
        launch.parse_args(["--worker-platform", "tpu", "python", "x.py"])
    assert launch.parse_args(["--worker-platform", "gpu", "python",
                              "x.py"]).worker_platform == "gpu"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"fusion-threshold-mb": 16,
                               "cycle-time-ms": 5.0}))
    argv = ["-np", "1", "--config-file", str(cfg), "python", "x.py"]
    got, ref = launch.parse_args(argv), ref_launch.parse_args(argv)
    assert (got.fusion_threshold_mb, got.cycle_time_ms) == \
        (ref.fusion_threshold_mb, ref.cycle_time_ms) == (16, 5.0)


def test_submit_raises_naming_item_10b():
    """``--submit`` now hands the job to a fleet gateway; with none
    answering at ``--gateway`` it exits naming the address, as the
    reference's does (the submission itself: test_torch_port_fleet.py)."""
    addr = f"127.0.0.1:{chips._free_port()}"
    with pytest.raises(SystemExit, match=f"no fleet gateway answering "
                                         f"at {addr}"):
        launch.main(["--submit", "--gateway", addr, "-np", "1", "python",
                     "x.py"])


@pytest.mark.parametrize("argv", [["--gateway", "h:1"], ["--priority", "2"],
                                  ["--tenant", "t"]])
def test_fleet_flags_wait_for_item_10b(argv):
    """``--submit``'s fleet flags parse as the reference's do."""
    tail = ["-np", "1", "python", "x.py"]
    got, ref = launch.parse_args(argv + tail), ref_launch.parse_args(
        argv + tail)
    assert (got.gateway, got.priority, got.tenant) == \
        (ref.gateway, ref.priority, ref.tenant)


@pytest.mark.parametrize("kw", [{"use_mpi": True}, {"use_gloo": False}])
def test_run_refuses_an_mpi_control_plane(kw):
    from horovod_tpu_torch.runner import run
    with pytest.raises(ValueError, match="MPI"):
        run(print, np=1, worker_platform="cpu", **kw)


def test_check_build_builds_nothing(capsys):
    from horovod_tpu_torch.ops import _build
    before = sorted(os.listdir(_build.BUILD_DIR)) \
        if os.path.isdir(_build.BUILD_DIR) else []
    assert launch.main(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "[X] PyTorch" in out and "CUDA" in out
    assert "flash-attention kernels built" in out
    after = sorted(os.listdir(_build.BUILD_DIR)) \
        if os.path.isdir(_build.BUILD_DIR) else []
    assert after == before


# --- the NIC probe --------------------------------------------------------

def test_local_addresses_match_reference():
    names = [n for _i, n in socket.if_nameindex()]
    for name in names:
        assert probe._iface_address(name) == ref_probe._iface_address(name)
        if ref_probe._iface_address(name) is not None:
            assert probe.local_addresses(iface=name) == \
                ref_probe.local_addresses(iface=name)
    assert probe.local_addresses(iface="lo") == ["127.0.0.1"]
    with pytest.raises(ValueError):
        probe.local_addresses(iface="definitely-not-a-nic0")
    everything = probe.local_addresses()
    assert everything[-1] == "127.0.0.1"
    for name in names:
        addr = ref_probe._iface_address(name)
        assert addr is None or addr in everything
    assert probe.advertised_driver_host([]) in everything


def test_probe_listener_round_trip_across_packages():
    assert probe.probe_script(["1.2.3.4"], 5, "t") == \
        ref_probe.probe_script(["1.2.3.4"], 5, "t")
    for Listener, check in ((probe.ProbeListener, ref_probe.check_reachable),
                            (ref_probe.ProbeListener, probe.check_reachable)):
        listener = Listener("tok-1")
        try:
            assert check("127.0.0.1", listener.port, "tok-1")
            assert not check("127.0.0.1", listener.port, "tok-2")
        finally:
            listener.close()


def _local_probe(host, script, ssh_port=None):
    """A remote probe run on this machine: the script as ssh would run
    it on each host."""
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=30)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_match_driver_address_matches_reference():
    hosts = ["fake-a", "fake-b"]
    for pkg in (probe, ref_probe):
        chosen, per_host = pkg.match_driver_address(
            hosts, remote_probe=_local_probe, iface="lo")
        assert chosen == "127.0.0.1"
        assert per_host == {h: ["127.0.0.1"] for h in hosts}
        chosen, per_host = pkg.match_driver_address(
            hosts, remote_probe=lambda *a: [], iface="lo")
        assert chosen is None and per_host == {h: [] for h in hosts}
        assert pkg.match_driver_address([]) == (None, {})


# --- fn shipping ----------------------------------------------------------

def _triple(x):
    return 3 * x


def test_fnpickle_round_trip_and_torn_result(tmp_path):
    path, results = fnpickle.dump_payload(str(tmp_path), lambda x: x + 1,
                                          (4,), {})
    payload = fnpickle.load_payload(path)
    assert payload["fn"](*payload["args"]) == 5
    # The result files cross packages: the reference's collector reads
    # the port's, and a killed worker's .tmp is ignored by both.
    fnpickle.write_result(results, 1, {"b": 2})
    ref_fnpickle.write_result(results, 0, [1.0])
    with open(os.path.join(results, ".rank_2.tmp"), "wb") as f:
        f.write(b"\x80torn")
    assert fnpickle.collect_results(results) == \
        ref_fnpickle.collect_results(results) == [[1.0], {"b": 2}]
    # A reused work dir drops the previous run's results.
    fnpickle.dump_payload(str(tmp_path), _triple, (), {})
    assert fnpickle.collect_results(results) == []


# --- discovery ------------------------------------------------------------

def test_gpu_discovery_matches_tpu_discovery(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "t0,t1,t2")
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", "v5litepod-24")
    monkeypatch.setenv("HVD_TPU_WORKER_HOSTNAMES", "t0,t1,t2")
    monkeypatch.setenv("HVD_TPU_CHIPS_PER_HOST", "8")
    ref_hosts, ref_cph = ref_discovery.discover_tpu_slice()
    hosts, cph = gpu_discovery.discover_gpu_hosts()
    assert [(h.hostname, h.slots) for h in hosts] == \
        [(h.hostname, h.slots) for h in ref_hosts]
    assert cph == ref_cph == 8
    assert chips.local_chip_inventory() == \
        ref_chips.local_chip_inventory() == (8, True)
    assert chips.host_chip_inventory("t1", False) == \
        ref_chips.host_chip_inventory("t1", False) == (8, True)
    monkeypatch.delenv("HVD_TPU_CHIPS_PER_HOST")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1")
    assert gpu_discovery.discover_gpu_hosts()[1] == 2
    assert chips.host_chip_inventory("elsewhere", False) == (-1, False)
    monkeypatch.delenv("HVD_TPU_WORKER_HOSTNAMES")
    assert gpu_discovery.discover_gpu_hosts() is None
    args = launch.parse_args(["-np", "3", "python", "x.py"])
    assert [(h.hostname, h.slots) for h in launch.resolve_hosts(args)] \
        == [("localhost", 3)]


def test_card_count_needs_no_cuda(monkeypatch):
    """CUDA_VISIBLE_DEVICES first (CUDA stops at a negative entry), then
    nvidia-smi -L, then the device files."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,2,-1,3")
    assert gpu_discovery.local_devices() == ["0", "2"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert gpu_discovery.local_devices() == []
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    smi_count = gpu_discovery._nvidia_smi_count
    monkeypatch.setattr(gpu_discovery.shutil, "which", lambda name: None)
    assert smi_count() is None   # no nvidia-smi: the device files count
    monkeypatch.setattr(gpu_discovery, "_nvidia_smi_count", lambda: 1)
    monkeypatch.setattr(gpu_discovery.glob, "glob",
                        lambda pat: ["/dev/nvidia0", "/dev/nvidia1"])
    assert gpu_discovery.local_devices() == ["0"]
    monkeypatch.setattr(gpu_discovery, "_nvidia_smi_count", lambda: None)
    assert gpu_discovery.local_devices() == ["0", "1"]


# --- init() under a plan --------------------------------------------------

def test_device_index_under_a_partition(monkeypatch):
    from horovod_tpu_torch.core.basics import device_index
    monkeypatch.delenv(chips.PARTITION_ENV, raising=False)
    assert [device_index(r) for r in range(4)] == [0, 1, 2, 3]
    plan = chips.plan_host_platform(4, chips=4, partitionable=True)
    for r in range(4):
        env = plan.slot_env(r, 4)
        assert env["CUDA_VISIBLE_DEVICES"] == str(r)
        monkeypatch.setenv(chips.PARTITION_ENV, env[chips.PARTITION_ENV])
        assert device_index(r) == 0


def test_cpu_slot_runs_gloo_and_an_unpinned_one_raises(monkeypatch):
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    for name in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_CONTROLLER_ADDR",
                 "HVD_TPU_ELASTIC_SLOT", "HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("HVD_TPU_WORKER_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    monkeypatch.setenv("HVD_TPU_WORKER_PLATFORM", "cpu")
    hvd.init()
    try:
        assert hvd.device() == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        assert torch.equal(hvd.allreduce(torch.ones(3), op=hvd.Sum),
                           torch.ones(3))
    finally:
        hvd.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init(device="cuda")


def test_init_refuses_an_unresolved_world_port(monkeypatch):
    """MASTER_PORT=auto reaches init() only from a command the launcher
    did not run through its bootstrap (a shell wrapper): init() names
    that instead of handing "auto" to env://."""
    import horovod_tpu_torch as hvd
    for name in ("HVD_TPU_CONTROLLER_ADDR", "HVD_TPU_ELASTIC_SLOT",
                 "HVD_TPU_ELASTIC", "HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HVD_TPU_RANK", "1")
    monkeypatch.setenv("HVD_TPU_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "auto")
    try:
        with pytest.raises(RuntimeError, match="MASTER_PORT=auto.*shell"):
            hvd.init(device="cpu")
    finally:
        hvd.shutdown()
