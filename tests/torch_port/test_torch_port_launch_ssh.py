"""The port's launcher over remote hosts: the ssh branch, the NIC probe
and the elastic driver's remote host sets, through the reference's
PATH-shimmed ``ssh`` (tests/test_ssh_launch.py:28-60), which records
each call, scrubs the inherited HVD_TPU_*/HOROVOD_* env and runs the
remote command here.  The hosts are loopback aliases (127.0.0.2 and
127.0.0.3): remote to the launcher, yet routable on this machine.  One
slot a host, on the CPU."""

import glob
import json
import os
import re
import stat
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from test_ssh_launch import SSH_SHIM  # noqa: E402

from horovod_tpu_torch.runner.chips import _free_port  # noqa: E402
from horovod_tpu_torch.runner.launch import main  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
HOSTS = ("127.0.0.2", "127.0.0.3")


@pytest.fixture
def ssh_log(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    shim = bin_dir / "ssh"
    shim.write_text(SSH_SHIM)
    shim.chmod(shim.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "ssh.log"
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setenv("HVD_TPU_TEST_SSH_LOG", str(log))
    return log


@pytest.mark.timeout(240)
def test_ssh_launch_two_fake_hosts(tmp_path, ssh_log):
    """Rank 0 on a remote host: its store port goes through the KV
    (MASTER_PORT=auto, resolved by the bootstrap), the secret through
    stdin, and the rendezvous at the probed address."""
    ident = tmp_path / "id_test"
    ident.write_text("not-a-real-key\n")
    outfile = str(tmp_path / "result")
    rc = main(["-np", "2", "-H", ",".join(f"{h}:1" for h in HOSTS),
               "--worker-platform", "cpu", "--ssh-port", "2299",
               "--ssh-identity-file", str(ident),
               "--controller-port", str(_free_port()),
               sys.executable, os.path.join(HERE,
                                            "_torch_port_launch_workers.py"),
               "static", json.dumps({"outfile": outfile})])
    assert rc == 0
    results = [json.load(open(f"{outfile}.{r}")) for r in range(2)]
    for r in results:
        assert (r["size"], r["local_size"], r["cross_size"], r["sum"]) == \
            (2, 1, 2, 3.0), r
        assert r["secret_present"], r
        assert r["master_port"].isdigit(), r
    assert [r["hostname"] for r in results] == list(HOSTS)
    lines = ssh_log.read_text().strip().splitlines()
    probes = [ln for ln in lines if "python3 -c" in ln]
    launches = [ln for ln in lines
                if "read -r HVD_TPU_RENDEZVOUS_SECRET" in ln]
    assert sorted(ln.split()[0] for ln in probes) == \
        [f"HOST={h}" for h in HOSTS]
    assert len(launches) == 2 and all(" PORT=2299 " in ln for ln in lines)
    for ln in launches:
        assert f" IDENT={ident} " in ln and "MASTER_PORT=auto" in ln, ln
        assert "horovod_tpu_torch.runner.bootstrap" in ln, ln
        # The secret rides stdin: no assignment of it in the remote line.
        assert "HVD_TPU_RENDEZVOUS_SECRET=" not in ln, ln
    _assert_probed(results[0]["rendezvous"], probes)


def _assert_probed(rendezvous, probes):
    """The advertised rendezvous is one of the candidates each host's
    probe was given (and reached: a host reaching none fails the
    match)."""
    host = rendezvous.rsplit(":", 1)[0]
    for ln in probes:
        assert f'"{host}"' in ln, (host, ln)


@pytest.mark.timeout(240)
def test_elastic_cli_over_remote_hosts(tmp_path, ssh_log):
    """--host-discovery-script over the two fake remote hosts, through
    main() and run_elastic: the driver probes them and advertises the
    probed address instead of refusing them; the workers respawn
    nothing and sum over the world of two."""
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\n" + "".join(f"echo {h}:1\n"
                                               for h in HOSTS))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    log = str(tmp_path / "log")
    rc = main(["--min-np", "2", "--max-np", "2",
               "--host-discovery-script", str(script), "--slots", "1",
               "--worker-platform", "cpu", "-v",
               sys.executable,
               os.path.join(HERE, "_torch_port_elastic_workers.py"),
               "allreduce", json.dumps({"log": log, "epochs": 2})])
    assert rc == 0
    events = {path[len(log) + 1:]: [json.loads(x) for x in open(path)]
              for path in glob.glob(log + ".*")}
    assert sorted(events) == [f"{h}:0" for h in HOSTS], events
    for evs in events.values():
        assert [e["sum"] for e in evs] == [3.0, 3.0], evs
        assert all(e["size"] == 2 for e in evs)
    lines = ssh_log.read_text().strip().splitlines()
    probes = [ln for ln in lines if "python3 -c" in ln]
    assert sorted(ln.split()[0] for ln in probes) == \
        [f"HOST={h}" for h in HOSTS]
    (rendezvous,) = {re.search(r"HVD_TPU_RENDEZVOUS_ADDR=(\S+)", ln)[1]
                     for ln in lines if "HVD_TPU_ELASTIC_SLOT=" in ln}
    _assert_probed(rendezvous, probes)
