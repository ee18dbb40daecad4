"""NAT/tunnel path for continuous serving across network boundaries.

Reference: `PortForwarding.forwardPortToRemote` (src/io/http/src/main/
scala/PortForwarding.scala:16-66) — each partition's HTTP server opens a
REVERSE ssh tunnel to a public gateway, scanning `remotePortStart +
attempt` until a free listen port is found, so clients outside the
cluster's NAT reach the per-partition servers; `HTTPSourceV2` wires it
under the `forwarding.*` options (HTTPSourceV2.scala:363-372).

TPU redesign: no jsch — the system `ssh` client (universally present
where a gateway is reachable) runs `-N -R` under a supervised
subprocess. `ExitOnForwardFailure=yes` turns "listen port busy" into a
fast nonzero exit, which drives the same port-scan loop as the
reference. The subprocess launcher is injectable so the scan/liveness
logic is testable without a real gateway (this build environment has
zero egress).

A copy of mmlspark_tpu/io_http/forwarding.py.
"""

from __future__ import annotations

import socket
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..resilience.policy import Clock, SYSTEM_CLOCK

__all__ = ["ForwardingOptions", "PortForward", "build_ssh_command",
           "establish_forward", "get_local_ip"]


def get_local_ip() -> str:
    """This host's outbound-facing IP (reference getLocalIp,
    HTTPSourceV2.scala:325-327). A connectionless UDP socket picks the
    routing-table answer without sending any packet. The probe target is a
    PUBLIC address (the reference uses one too): probing 10/8 would return
    127.0.0.1 on any host without an RFC-1918 route even though it has a
    perfectly good default route."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


@dataclass
class ForwardingOptions:
    """The reference's `forwarding.*` option set (PortForwarding.scala:68-81),
    flattened to a typed record. `remote_port_start` defaults to the local
    port, exactly like the reference's orElse chain."""

    username: str
    ssh_host: str
    ssh_port: int = 22
    bind_address: str = "*"
    remote_port_start: int | None = None
    key_file: str | None = None
    max_retries: int = 50
    connect_timeout_s: float = 20.0
    extra_ssh_args: tuple[str, ...] = ()
    # the client binary; picklable across the fleet's spawn boundary
    # (unlike an injected launcher), and swappable for a stub in tests
    ssh_command: str = "ssh"
    # auth/handshake margin on top of ConnectTimeout in the settle window
    # (establish_forward): tunable here because the fleet path has no
    # other way to bound per-attempt wait when the gateway is fast
    settle_margin_s: float = 5.0


def build_ssh_command(opts: ForwardingOptions, remote_port: int,
                      local_host: str, local_port: int) -> list[str]:
    """argv for one reverse-forward attempt. Pure so the exact contract —
    flags, bind syntax, failure mode — is unit-testable."""
    cmd = [
        opts.ssh_command, "-N",
        # listen-port-busy must FAIL the process (the scan signal), not
        # degrade to a warning while ssh stays connected
        "-o", "ExitOnForwardFailure=yes",
        # no interactive auth: a gateway that falls back to a password
        # prompt must exit nonzero immediately, not sit at the prompt for
        # the whole settle window and register as an established tunnel
        "-o", "BatchMode=yes",
        "-o", "StrictHostKeyChecking=no",
        "-o", f"ConnectTimeout={max(int(opts.connect_timeout_s), 1)}",
        # a half-dead gateway must not leave a zombie forward behind NAT:
        # miss 3 keepalives (~45 s) and the tunnel tears down
        "-o", "ServerAliveInterval=15",
        "-o", "ServerAliveCountMax=3",
        "-p", str(opts.ssh_port),
    ]
    if opts.key_file:
        cmd += ["-i", opts.key_file]
    cmd += list(opts.extra_ssh_args)
    # an -R spec with NO bind address listens on the gateway's LOOPBACK
    # only — useless for NAT traversal. The default "*" must be emitted
    # explicitly ("*:port:...") to bind all interfaces (the gateway's sshd
    # needs GatewayPorts yes|clientspecified, same as the reference's jsch
    # setPortForwardingR("*", ...) deployment); "" opts into loopback.
    bind = "" if opts.bind_address == "" else f"{opts.bind_address}:"
    cmd += ["-R", f"{bind}{remote_port}:{local_host}:{local_port}"]
    cmd += [f"{opts.username}@{opts.ssh_host}"]
    return cmd


@dataclass
class PortForward:
    """A live reverse tunnel: `ssh_host:remote_port` -> local server."""

    remote_host: str
    remote_port: int
    local_port: int
    _proc: object = field(default=None, repr=False)

    @property
    def public_address(self) -> tuple[str, int]:
        return self.remote_host, self.remote_port

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def status(self) -> dict:
        """Health-probe payload: tunnel liveness + coordinates (surfaced
        under the serving `/healthz` extras so a dead ssh shows up in the
        fleet health view instead of silently blackholing traffic)."""
        return {"alive": self.alive(), "remote_host": self.remote_host,
                "remote_port": self.remote_port,
                "local_port": self.local_port}

    def close(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:  # noqa: BLE001 — last resort on a hung ssh
                self._proc.kill()


def _default_launcher(cmd: Sequence[str]):
    # stdin=DEVNULL: with no tty, anything in ssh that still tries to read
    # (a stray prompt BatchMode missed, host-key confirmation on an odd
    # sshd) gets EOF and dies instead of blocking on the parent's stdin
    return subprocess.Popen(
        list(cmd), stdin=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def establish_forward(
    local_port: int,
    opts: ForwardingOptions,
    local_host: str = "127.0.0.1",
    launcher: Callable[[Sequence[str]], object] = _default_launcher,
    settle_s: float | None = None,
    clock: "Clock | None" = None,
) -> PortForward:
    """Scan remote listen ports from `remote_port_start` (default: the
    local port), launching one reverse-forward attempt per candidate,
    until one SURVIVES the settle window — the reference's
    `setPortForwardingR` retry loop (PortForwarding.scala:46-62).

    With ExitOnForwardFailure, a busy listen port (or auth/connect
    failure) exits nonzero; a process still alive after the settle
    window holds an established tunnel. The window must therefore OUTLAST
    the slowest legitimate path to failure — TCP connect (bounded by
    ConnectTimeout) plus auth — or a still-connecting ssh would be
    reported as an established tunnel and registered in the rendezvous;
    hence the default of connect_timeout_s + settle_margin_s. Pass an
    explicit settle_s (or tune the margin in ForwardingOptions) only when
    the gateway's connect+auth latency is known."""
    if clock is None:
        clock = SYSTEM_CLOCK
    if settle_s is None:
        settle_s = opts.connect_timeout_s + opts.settle_margin_s
    start = (opts.remote_port_start
             if opts.remote_port_start is not None else local_port)
    for attempt in range(opts.max_retries + 1):
        remote_port = start + attempt
        proc = launcher(build_ssh_command(
            opts, remote_port, local_host, local_port))
        deadline = clock.monotonic() + settle_s
        failed = False
        while clock.monotonic() < deadline:
            if proc.poll() is not None:
                failed = True
                break
            clock.sleep(0.05)
        if not failed:
            return PortForward(
                remote_host=opts.ssh_host, remote_port=remote_port,
                local_port=local_port, _proc=proc)
    raise RuntimeError(
        f"could not establish a reverse forward on any port in "
        f"[{start}, {start + opts.max_retries}] via "
        f"{opts.username}@{opts.ssh_host} — every ssh attempt exited "
        "during the settle window (busy listen ports, auth failure, or "
        "an unreachable gateway)"
    )
