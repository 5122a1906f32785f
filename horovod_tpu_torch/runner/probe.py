"""Driver↔task connectivity probe and interface matching (port of
horovod_tpu/runner/probe.py).

Capability parity with the upstream driver/task probe services
(runner/driver/driver_service.py:49-218): before launching, the driver must
learn which of its addresses every worker host can actually route to —
``socket.gethostname()`` may resolve to an interface a remote host cannot
reach (multi-NIC machines, VPN/overlay networks, containers).

The driver opens a short-lived token-echo listener on all interfaces;
each remote host runs a tiny python probe (over the same ssh channel the
launcher already uses) that tries every candidate driver address and
reports the reachable set; the launcher advertises the first address
every host agreed on.  The token ties the answer to this launch.

Two differences from the reference: ``local_addresses`` lists the
interfaces' addresses without asking the routing table for the egress
toward a public address (a UDP ``connect`` to 8.8.8.8: the hosts the
port runs on may reach no outside host), and a launch without remote
hosts advertises this host's resolved address (loopback when the name
does not resolve) rather than its bare name.  The recovery endpoints'
address is ``rendezvous.advertised_host``, which this module leaves
alone.
"""

from __future__ import annotations

import json
import socket
import struct
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple


def _iface_address(ifname: str) -> Optional[str]:
    """IPv4 address of one named interface via SIOCGIFADDR (Linux)."""
    try:
        import fcntl
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            packed = fcntl.ioctl(
                s.fileno(), 0x8915,  # SIOCGIFADDR
                struct.pack("256s", ifname.encode()[:15]))
            return socket.inet_ntoa(packed[20:24])
        finally:
            s.close()
    except (ImportError, OSError):
        return None


def _host_address() -> Optional[str]:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return None


def local_addresses(iface: Optional[str] = None) -> List[str]:
    """All usable local IPv4 addresses, most-routable first (non-loopback
    interface addresses, then the hostname's resolution, then loopback).
    With ``iface`` (reference --network-interface / HOROVOD_GLOO_IFACE),
    only that interface's address is advertised."""
    addrs: List[str] = []

    def _add(a: Optional[str]):
        if a and a not in addrs:
            addrs.append(a)

    if iface:
        _add(_iface_address(iface))
        if not addrs:
            raise ValueError(
                f"--network-interface {iface!r} has no usable IPv4 address")
        return addrs
    try:
        names = [n for _idx, n in socket.if_nameindex()]
    except OSError:
        names = []
    for ifname in names:
        a = _iface_address(ifname)
        if a and not a.startswith("127."):
            _add(a)
    _add(_host_address())
    _add("127.0.0.1")
    return addrs


class ProbeListener:
    """Token-echo TCP listener on all interfaces: a prober that connects
    and sends the launch token gets it echoed back — proof of mutual
    routability on that address."""

    def __init__(self, token: str, port: int = 0):
        self.token = token.encode()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(2.0)
                data = conn.recv(len(self.token))
                if data == self.token:
                    conn.sendall(self.token)
            except OSError:
                pass
            finally:
                conn.close()

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2)


def check_reachable(addr: str, port: int, token: str,
                    timeout: float = 2.0) -> bool:
    """Can this process reach the probe listener at addr:port?"""
    try:
        with socket.create_connection((addr, port), timeout=timeout) as s:
            s.settimeout(timeout)
            s.sendall(token.encode())
            return s.recv(len(token)) == token.encode()
    except OSError:
        return False


def probe_script(candidates: List[str], port: int, token: str) -> str:
    """The python -c body a remote host runs to report which candidate
    driver addresses it can reach (JSON list on stdout)."""
    payload = json.dumps({"candidates": candidates, "port": port,
                          "token": token})
    return (
        "import json,socket,sys\n"
        f"cfg=json.loads({payload!r})\n"
        "ok=[]\n"
        "for a in cfg['candidates']:\n"
        "    try:\n"
        "        s=socket.create_connection((a,cfg['port']),timeout=2)\n"
        "        s.settimeout(2); s.sendall(cfg['token'].encode())\n"
        "        if s.recv(len(cfg['token']))==cfg['token'].encode():"
        " ok.append(a)\n"
        "        s.close()\n"
        "    except OSError: pass\n"
        "print(json.dumps(ok))\n")


def _run_remote_probe(hostname: str, script: str,
                      ssh_port: Optional[int] = None,
                      timeout: float = 20.0) -> List[str]:
    import shlex
    ssh_cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
               "-o", "ConnectTimeout=5"]
    if ssh_port:
        ssh_cmd += ["-p", str(ssh_port)]
    # The remote shell re-splits the command line: the script (which
    # contains quotes from its JSON payload) must be shell-quoted whole.
    remote = f"python3 -c {shlex.quote(script)}"
    try:
        out = subprocess.run(ssh_cmd + [hostname, remote],
                             capture_output=True, text=True,
                             timeout=timeout)
    except (subprocess.TimeoutExpired, OSError):
        return []
    if out.returncode != 0:
        return []
    try:
        return list(json.loads(out.stdout.strip().splitlines()[-1]))
    except (ValueError, IndexError):
        return []


def match_driver_address(remote_hosts: List[str],
                         ssh_port: Optional[int] = None,
                         token: Optional[str] = None,
                         remote_probe=_run_remote_probe,
                         iface: Optional[str] = None
                         ) -> Tuple[Optional[str], Dict[str, List[str]]]:
    """Find a driver address every remote host can route to.

    Returns (chosen address | None, per-host reachable lists).  None means
    no common address — the caller should fail with the per-host report
    rather than launch a job that cannot rendezvous.  ``remote_probe`` is
    injectable (test seam; production uses ssh).
    """
    import secrets
    from concurrent.futures import ThreadPoolExecutor
    if not remote_hosts:
        return None, {}
    token = token or secrets.token_hex(8)
    candidates = local_addresses(iface=iface)
    listener = ProbeListener(token)
    per_host: Dict[str, List[str]] = {}
    try:
        script = probe_script(candidates, listener.port, token)
        # Probes are independent — run them concurrently (a few slow hosts
        # must not serialize into minutes of startup latency).
        with ThreadPoolExecutor(max_workers=min(32, len(remote_hosts))) \
                as pool:
            futures = {host: pool.submit(remote_probe, host, script,
                                         ssh_port)
                       for host in remote_hosts}
            for host, fut in futures.items():
                try:
                    per_host[host] = fut.result()
                except Exception:  # noqa: BLE001 - treat as unreachable
                    per_host[host] = []
    finally:
        listener.close()
    common = [a for a in candidates
              if all(a in reach for reach in per_host.values())]
    return (common[0] if common else None), per_host


def advertised_driver_host(remote_hostnames: List[str],
                           ssh_port: Optional[int] = None,
                           iface: Optional[str] = None) -> str:
    """The address the driver advertises for rendezvous (the reference's
    ``probe.advertised_host``): a probed mutually-routable address when
    there are remote hosts, else this host's own.  Shared by the static
    and elastic launch paths."""
    if not remote_hostnames:
        if iface:
            addr = _iface_address(iface)
            if addr is None:
                raise ValueError(f"--network-interface {iface!r} has no "
                                 "usable IPv4 address")
            return addr
        return _host_address() or "127.0.0.1"
    chosen, per_host = match_driver_address(remote_hostnames,
                                            ssh_port=ssh_port, iface=iface)
    if chosen is not None:
        return chosen
    fallback = _host_address() or socket.gethostname()
    print(f"[hvdrun] WARNING: no driver address reachable from all of "
          f"{remote_hostnames} (probe results: {per_host}); falling back "
          f"to {fallback}", file=sys.stderr)
    return fallback
