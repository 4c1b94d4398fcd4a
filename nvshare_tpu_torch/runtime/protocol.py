"""Python mirror of the tpushare wire protocol (see src/comm.hpp), the
port's own copy of the JAX package's ``runtime/protocol.py``.

The native control plane is C++; this mirror exists so pure-Python clients,
tests, and tools can speak to ``tpushare-scheduler`` directly. Protocol
parity notes: same eight message semantics as the reference's comm.h:59-68
(grgalex/nvshare) plus GET_STATS/STATS, carried in fixed 304-byte packed
frames over a UNIX stream socket under ``$TPUSHARE_SOCK_DIR`` (default
``/var/run/tpushare``).
"""

from __future__ import annotations

import enum
import os
import socket
import struct
from dataclasses import dataclass

MAGIC = 0x48535054  # "TPSH" little-endian
VERSION = 1
IDENT_LEN = 140
# magic u32 | version u8 | type u8 | reserved u16 | client_id u64 | arg i64
# | job_name 140s | job_namespace 140s   == 304 bytes, no padding.
_FRAME = struct.Struct("<IBBHQq140s140s")
FRAME_SIZE = _FRAME.size
assert FRAME_SIZE == 304

UNREGISTERED_ID = 0xD15C0B01D15C0B01

#: REGISTER ``arg`` is a capability bitmask (0 from pre-capability
#: clients, whose REGISTER always carried arg=0). Bit 0: this client
#: understands the LOCK_NEXT on-deck advisory — the scheduler only sends
#: it to clients that declared the bit, so version skew in either
#: direction degrades to the plain synchronous protocol.
CAP_LOCK_NEXT = 1
#: Bit 1: this connection streams TELEMETRY_PUSH lines (fleet plane).
CAP_TELEMETRY = 2
#: Bit 2: observer-only connection (the fleet streamer's side channel):
#: never competes for the device lock; excluded from the scheduler's
#: ``clients=``/fairness output.
CAP_OBSERVER = 4
#: Bit 3: this client declares a QoS spec (``TPUSHARE_QOS=class:weight``).
#: The spec itself rides the HIGH bits of the same REGISTER arg — zero
#: new frames and zero new fields, exactly the :data:`CAP_LOCK_NEXT`
#: degradation story: with the env unset the arg stays 0 here
#: (byte-for-byte reference wire exchange), and an old scheduler ignores
#: bits it doesn't know. See :mod:`nvshare_tpu_torch.qos.spec` for the
#: parser/encoder both runtimes share.
CAP_QOS = 8
#: Bit 4: this client consumes :data:`MsgType.GRANT_HORIZON` advisories
#: (its pager stages against the published schedule instead of the
#: one-slot LOCK_NEXT hint). Same degradation story as
#: :data:`CAP_LOCK_NEXT`: undeclared ⇒ the scheduler never emits the
#: frame, so a pager without first-touch staging keeps the exact
#: pre-horizon wire exchange.
CAP_HORIZON = 16
#: Bit 5: this client may send :data:`MsgType.PHASE_INFO` serving-phase
#: advisories (``TPUSHARE_PHASE=1``). The scheduler re-classes only
#: declared senders; unset keeps the bit 0 — the exact pre-phase
#: REGISTER arg.
CAP_PHASE = 32
#: Bit 6 (COORD-plane hello, host sched → coordinator): this host runs
#: the federation client (``TPUSHARE_FED``) and understands
#: FED_ROUND/FED_NEXT. A fed coordinator opens rounds on such hosts with
#: leased FED_ROUND frames; hosts without the bit get plain GANG_GRANT
#: (a plain gang coordinator ignores hello args, so skew degrades to
#: unleased gang rounds).
CAP_FED_HOST = 64
#: Latency-class id field: bits [QOS_CLASS_SHIFT, +4).
QOS_CLASS_SHIFT = 8
QOS_CLASS_MASK = 0xF
#: Entitlement weight field: bits [QOS_WEIGHT_SHIFT, +8), 1..255.
QOS_WEIGHT_SHIFT = 16
QOS_WEIGHT_MASK = 0xFF
QOS_CLASS_BATCH = 0        #: throughput tenants (the default class)
QOS_CLASS_INTERACTIVE = 1  #: latency tenants (may preempt batch holders)

#: The SCHED_ON/SCHED_OFF register reply's ``arg`` is the *scheduler's*
#: capability bitmask (older daemons replied arg=0, which older clients
#: ignored). Bit 0: the scheduler accepts TELEMETRY_PUSH — a client must
#: not stream without seeing it (an old daemon treats type 20 as fatal).
SCHED_CAP_TELEMETRY = 1
#: Bit 1: the scheduler runs warm-restart recovery (``TPUSHARE_STATE_DIR``
#: + ``TPUSHARE_WARM_RESTART``) and accepts REHOLD_INFO; a client must not
#: send that frame without seeing the bit (an old daemon treats type 24
#: as a fatal unknown). Reference-parity daemons never set it.
SCHED_CAP_WARM_RESTART = 2
#: Bit 2: the scheduler runs phase-aware re-classing (daemon-side
#: ``TPUSHARE_PHASE=1``) and accepts PHASE_INFO; a client must not send
#: that frame without seeing the bit (an old daemon treats type 25 as a
#: fatal unknown). Phase-less daemons never set it.
SCHED_CAP_PHASE = 4

#: GET_STATS ``arg`` bits (old ctls always sent 0). Bit 0: also replay
#: the buffered TELEMETRY_PUSH frames (drained) after the detail frames.
STATS_WANT_TELEM = 1
#: Bit 1: also drain the arbiter flight-recorder journal as FLIGHT_REC
#: frames after everything else. The summary grows ``flight=``/``fdrop=``
#: only on such a request against a ``TPUSHARE_FLIGHT=1`` daemon — plain
#: requests (and recorder-less daemons) stay byte-for-byte pre-flight.
STATS_WANT_FLIGHT = 2
#: Bit 2: also send one wait-cause detail frame (PAGING_STATS carrying a
#: full ``wc=cause:ms,...`` partition, tenant name in the namespace
#: field) per tenant with attributed wait, after the fairness rows. The
#: overflow summary grows ``wcrows=N`` only on such a request against a
#: ``TPUSHARE_FLIGHT=1`` daemon. Dedicated frames because the 139-byte
#: fairness row tail-truncates under load; non-draining (unlike bit 1),
#: so scrapers may poll freely.
STATS_WANT_WC = 4

#: PHASE_INFO ``arg`` values — one tenant's declared serving phase.
PHASE_IDLE = 0      #: between requests (the default)
PHASE_PREFILL = 1   #: throughput-bound prompt pass
PHASE_DECODE = 2    #: latency-bound token loop
#: Spelled phase names <-> wire ids (the Python API surface takes
#: strings; the wire carries the int).
PHASE_IDS = {"idle": PHASE_IDLE, "prefill": PHASE_PREFILL,
             "decode": PHASE_DECODE}
PHASE_NAMES = {v: k for k, v in PHASE_IDS.items()}


class MsgType(enum.IntEnum):
    REGISTER = 1
    SCHED_ON = 2
    SCHED_OFF = 3
    REQ_LOCK = 4
    #: sched → client: you hold the device lock (arg = TQ seconds). Under
    #: lease enforcement (``TPUSHARE_REVOKE_GRACE_S`` != off) ``job_name``
    #: carries the grant's monotonically increasing FENCING EPOCH as an
    #: ``epoch=N`` token — echo it in LOCK_RELEASED's ``arg``. With
    #: enforcement off the frame stays byte-for-byte reference parity.
    #: Under capacity-aware co-residency (``TPUSHARE_COADMIT=1``,
    #: scheduler-side) this frame may arrive while ANOTHER tenant also
    #: holds — a concurrent grant with its own epoch. Clients need no
    #: special handling (a grant is a grant; demotion arrives as an
    #: ordinary DROP_LOCK), which is exactly why the feature costs zero
    #: new wire surface.
    LOCK_OK = 5
    DROP_LOCK = 6
    #: client → sched: lock given back (arg = the grant's fencing epoch
    #: when LOCK_OK carried one, else 0). The scheduler discards a
    #: positive echo that doesn't name the live grant, so a
    #: revoked-then-revived holder replaying an old release (possibly
    #: across a reconnect) can never cancel a successor's grant or its
    #: own re-queued request.
    LOCK_RELEASED = 7
    SET_TQ = 8
    GET_STATS = 9
    STATS = 10
    #: client → sched: per-tenant paging-health line (cvmem counters) in
    #: ``job_name``; sched → ctl: one frame per client after ``STATS``
    #: (the summary's ``paging=N`` announces how many follow).
    PAGING_STATS = 11
    #: Gang scheduling (multi-host; tpushare addition — the reference is
    #: single-GPU). The gang id travels in ``job_name`` on every gang frame.
    #: client → sched: I am a member of this gang (arg = world, the number
    #: of participating hosts).
    GANG_INFO = 12
    #: host sched → coordinator: a member wants its local lock (arg = world).
    GANG_REQ = 13
    #: coordinator → host sched: round started — member may hold the lock.
    GANG_GRANT = 14
    #: host sched → coordinator: the member now holds this host's lock.
    GANG_ACK = 15
    #: coordinator → host sched: round over — drop the member.
    #: host sched → coordinator: yield request (locals starving).
    GANG_DROP = 16
    #: host sched → coordinator: the member released this host's lock.
    GANG_RELEASED = 17
    #: host sched → coordinator: no local member wants the lock any more.
    GANG_DEREQ = 18
    #: sched → client: "you're on deck" — the client is first in line for
    #: the next grant (arg = remaining ms of the current holder's quantum,
    #: best-effort). Purely ADVISORY: it never grants anything; the
    #: proactive pager uses it to stage its hot set host-side and plan
    #: prefetch before LOCK_OK. Clients that don't understand it ignore
    #: it (see the unknown-type tolerance in :meth:`Msg.unpack`).
    LOCK_NEXT = 19
    #: client → sched: one compact telemetry line (trace event or metric
    #: snapshot, fleet plane) in ``job_name``; purely advisory. sched →
    #: ctl: replay frame after STATS when GET_STATS asked with
    #: :data:`STATS_WANT_TELEM` (arg = arrival ms on the scheduler clock,
    #: ``job_namespace`` = sender name; the summary's ``telem=N``
    #: announces how many follow). See nvshare_tpu_torch/telemetry/fleet.py.
    TELEMETRY_PUSH = 20
    #: sched → client: your lease was revoked (grace expired with
    #: LOCK_RELEASED still outstanding); arg = the revoked grant's
    #: fencing epoch. Sent BEST-EFFORT immediately before the scheduler
    #: retires the holder's fd, so a revoked tenant can block at the gate
    #: and re-queue instead of free-running the revoked window. The fd
    #: close stays authoritative — a lost frame degrades to the plain
    #: death-path behavior — and pre-REVOKED clients ignore the type
    #: (see :meth:`Msg.unpack`). Only ever sent on the revocation path,
    #: which only exists under lease enforcement.
    REVOKED = 21
    #: sched → client: published grant horizon — this client is one of
    #: the next K predicted holders (``arg`` = best-effort ETA ms until
    #: its predicted grant; ``job_name`` carries ``d=<pos> n=<len>``,
    #: the 1-based horizon position and horizon length, with ``d=0``
    #: meaning "dropped out — cancel staging"). Purely ADVISORY, like
    #: :data:`LOCK_NEXT`: the grant path never consults the horizon.
    #: Capability-gated on :data:`CAP_HORIZON`; ``TPUSHARE_HORIZON_DEPTH``
    #: sizes K scheduler-side.
    GRANT_HORIZON = 22
    #: sched → ctl: one arbiter flight-recorder journal record, replayed
    #: after STATS when GET_STATS asked with :data:`STATS_WANT_FLIGHT`
    #: (drained; the summary's ``flight=N`` announces how many follow).
    #: ``job_name`` carries the record's ``k=v`` line (clipped at a token
    #: boundary — the STATS mid-token guard); ``arg`` = the record's
    #: virtual-clock stamp (scheduler monotonic ms). Only ever sent when
    #: the recorder is on (``TPUSHARE_FLIGHT=1``) AND the ctl set the
    #: bit, so old ctls keep the exact pre-flight wire exchange. See
    #: ``tools/flight`` for the journal format and the incident-replay
    #: pipeline (docs/TELEMETRY.md).
    FLIGHT_REC = 23
    #: client → sched: "my last session ended with this fencing epoch
    #: still HELD" (``arg`` = that epoch). Sent exactly once, right after
    #: a re-REGISTER that followed a link death while holding, and ONLY
    #: when the register reply advertised :data:`SCHED_CAP_WARM_RESTART`
    #: (an old daemon treats the type as a fatal unknown). A
    #: warm-restarted scheduler uses it to distinguish died-mid-hold from
    #: clean rejoin while pacing the reconnect storm; purely
    #: informational — the fencing epoch check already discards stale
    #: pre-crash LOCK_RELEASED echoes (docs/ROBUSTNESS.md).
    REHOLD_INFO = 24
    #: client → sched: serving-phase advisory (``arg`` =
    #: :data:`PHASE_IDLE`/:data:`PHASE_PREFILL`/:data:`PHASE_DECODE`).
    #: An LLM tenant declares its phase transition so the arbiter
    #: re-classes it dynamically (decode ≙ interactive latency class,
    #: prefill ≙ batch; docs/SCHEDULING.md) — declared weight untouched,
    #: no grant/queue/lease state moved (model-checked), so a dropped
    #: frame degrades to "never sent". Gated both ways like REHOLD_INFO:
    #: sent only under ``TPUSHARE_PHASE=1`` (which declares
    #: :data:`CAP_PHASE`) and only to a daemon that advertised
    #: :data:`SCHED_CAP_PHASE`.
    PHASE_INFO = 25
    #: ctl → sched: hot-load an arbitration policy program. ``job_name``
    #: carries one chunk of the policy TEXT (the restricted rank/quantum
    #: DSL — docs/SCHEDULING.md "policy engine"); ``arg`` is a
    #: :data:`POLICY_LOAD_BEGIN`/:data:`POLICY_LOAD_COMMIT`/
    #: :data:`POLICY_LOAD_ROLLBACK` flag mask. COMMIT runs the
    #: three-stage gate (static verify + model-check DFS, shadow scoring
    #: against the flight ring, guarded cutover with SLO auto-rollback).
    #: sched → ctl: one reply frame of the same type (``arg`` = 0
    #: accepted / nonzero reject stage, ``job_name`` = verdict text).
    #: Gated on ``TPUSHARE_POLICY_LOAD``: an unarmed daemon treats type
    #: 26 as a fatal unknown, exactly the REHOLD_INFO story.
    POLICY_LOAD = 26
    #: Federation plane (tpushare-fed coordinator tier, COORD TCP link;
    #: docs/FEDERATION.md). host sched → fed: published scheduling
    #: stream — ``job_name`` carries one ``g=<gang> w=<weight> vt=<ms>
    #: q=<depth>`` line per queued gang (one frame each) or a bare
    #: heartbeat (empty ``job_name``); ``arg`` = the host's monotonic
    #: clock ms. Purely informational: feeds the coordinator's WFQ books
    #: and liveness view, never grants. Gated on ``TPUSHARE_FED``
    #: host-side; unset sends zero new frames.
    FED_STATS = 27
    #: fed → host sched: gang round opened UNDER A ROUND LEASE.
    #: ``job_name`` = gang id, ``arg`` = lease ms (0 = unleased, plain
    #: GANG_GRANT semantics), ``job_namespace`` = the round's
    #: expected-slowest host (wait-cause blame label). The host opens
    #: the gang window exactly like GANG_GRANT and arms a local round
    #: deadline; an expired round drains through the host's own
    #: DROP_LOCK → lease → revoke path — a coordinator can bound a
    #: round but never bypass a host lease. Only sent to hosts whose
    #: hello declared :data:`CAP_FED_HOST`.
    FED_ROUND = 28
    #: fed → host sched: next-round staging advisory. ``job_name`` = the
    #: gang predicted to run next, ``arg`` = best-effort ETA ms,
    #: ``job_namespace`` = the ACTIVE round's slowest host (blame
    #: refresh). The host pre-advises its queued member via the
    #: existing LOCK_NEXT plumbing; grant/queue/lease state never moves.
    FED_NEXT = 29


#: POLICY_LOAD ``arg`` flags (ctl → sched). A single-chunk load sends
#: BEGIN|COMMIT in one frame; multi-chunk loads send BEGIN on the first
#: chunk, bare chunks in between, and COMMIT on the last.
POLICY_LOAD_BEGIN = 1     #: reset the per-fd staging buffer
POLICY_LOAD_COMMIT = 2    #: run the three-stage gate now
POLICY_LOAD_ROLLBACK = 4  #: abandon the active program for the incumbent


@dataclass
class Msg:
    #: Usually a :class:`MsgType`; a plain ``int`` when the peer speaks a
    #: newer protocol revision than this module knows (forward compat:
    #: an unknown type must be ignorable, not fatal — see :meth:`unpack`).
    type: "MsgType | int"
    client_id: int = 0
    arg: int = 0
    job_name: str = ""
    job_namespace: str = ""

    def pack(self) -> bytes:
        return _FRAME.pack(
            MAGIC,
            VERSION,
            int(self.type),
            0,
            self.client_id,
            self.arg,
            self.job_name.encode()[: IDENT_LEN - 1],
            self.job_namespace.encode()[: IDENT_LEN - 1],
        )

    @staticmethod
    def unpack(raw: bytes) -> "Msg":
        magic, version, mtype, _, cid, arg, name, ns = _FRAME.unpack(raw)
        if magic != MAGIC or version != VERSION:
            raise ValueError(
                f"bad frame (magic={magic:#x} version={version})"
            )
        # Forward compatibility: a frame whose magic/version check out but
        # whose type this build doesn't know is a VALID frame from a newer
        # peer (e.g. a LOCK_NEXT-speaking scheduler talking to an old
        # client). Surface it with the raw int type so receivers can skip
        # it; raising here used to kill the whole connection over one
        # ignorable advisory.
        try:
            mtype = MsgType(mtype)
        except ValueError:
            pass
        return Msg(
            type=mtype,
            client_id=cid,
            arg=arg,
            job_name=name.split(b"\0", 1)[0].decode(errors="replace"),
            job_namespace=ns.split(b"\0", 1)[0].decode(errors="replace"),
        )


def socket_dir() -> str:
    return os.environ.get("TPUSHARE_SOCK_DIR") or "/var/run/tpushare"


def scheduler_socket_path() -> str:
    return os.path.join(socket_dir(), "scheduler.sock")


def default_job_name() -> str:
    # Inside Kubernetes, HOSTNAME is the pod name (≙ reference client.c:116).
    return (
        os.environ.get("TPUSHARE_JOB_NAME")
        or os.environ.get("HOSTNAME")
        or f"pid-{os.getpid()}"
    )


class SchedulerLink:
    """A connection to tpushare-scheduler speaking whole frames.

    Used by tests (as a scriptable fake client, the unit-test layer the
    reference lacks — SURVEY §4) and by the pure-Python client fallback.
    """

    def __init__(self, path: str | None = None, job_name: str | None = None,
                 namespace: str = ""):
        self.path = path or scheduler_socket_path()
        self.job_name = job_name or default_job_name()
        self.namespace = namespace or os.environ.get("TPUSHARE_NAMESPACE", "")
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # The daemon's socket file exists between bind() and listen(); a
        # connect in that window is refused. Retry briefly before giving
        # up. A missing socket file (no daemon at all) fails immediately.
        import time as _time

        deadline = _time.monotonic() + 2.0
        while True:
            try:
                self.sock.connect(self.path)
                break
            except ConnectionRefusedError:
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.05)
        # Deterministic fault injection ($TPUSHARE_CHAOS): wraps the
        # connected socket in a frame drop/delay/truncation proxy. Unset
        # (the default) this returns the socket unchanged — zero overhead
        # and zero behavior change.
        from nvshare_tpu_torch.runtime.chaos import maybe_wrap_socket

        self.sock = maybe_wrap_socket(self.sock)
        self.client_id = 0
        #: Scheduler capability bitmask from the register reply's arg
        #: (0 until :meth:`register` returns, and from pre-capability
        #: daemons — absence of a bit degrades to the plain protocol).
        self.sched_caps = 0

    def send(self, mtype: MsgType, arg: int = 0,
             client_id: int | None = None,
             job_name: str | None = None) -> None:
        # job_name override: PAGING_STATS carries a counters line in the
        # identity field instead of the pod name.
        msg = Msg(
            type=mtype,
            client_id=self.client_id if client_id is None else client_id,
            arg=arg,
            job_name=self.job_name if job_name is None else job_name,
            job_namespace=self.namespace,
        )
        self.sock.sendall(msg.pack())

    def recv(self, timeout: float | None = 10.0) -> Msg:
        self.sock.settimeout(timeout)
        buf = b""
        while len(buf) < FRAME_SIZE:
            chunk = self.sock.recv(FRAME_SIZE - len(buf))
            if not chunk:
                raise ConnectionError("scheduler closed the connection")
            buf += chunk
        return Msg.unpack(buf)

    def register(self, timeout: float = 10.0,
                 caps: int = 0) -> tuple[int, bool]:
        """REGISTER (declaring ``caps``, e.g. :data:`CAP_LOCK_NEXT`) and
        wait for SCHED_ON/OFF carrying our assigned id."""
        self.send(MsgType.REGISTER, arg=caps)
        reply = self.recv(timeout)
        if reply.type not in (MsgType.SCHED_ON, MsgType.SCHED_OFF):
            raise ProtocolError(f"unexpected register reply {reply.type!r}")
        self.client_id = reply.client_id
        self.sched_caps = reply.arg
        return self.client_id, reply.type == MsgType.SCHED_ON

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "SchedulerLink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProtocolError(RuntimeError):
    pass


def parse_grant_epoch(job_name: str) -> int:
    """The fencing epoch from a LOCK_OK ``job_name`` (``epoch=N`` token).

    0 when absent — a pre-lease scheduler, or lease enforcement off — in
    which case the client must echo 0 (the exact pre-fencing bytes) in
    LOCK_RELEASED.
    """
    for tok in job_name.split():
        if tok.startswith("epoch="):
            try:
                return max(0, int(tok[6:]))
            except ValueError:
                return 0
    return 0


def parse_horizon(job_name: str) -> tuple[int, int]:
    """``(position, length)`` from a GRANT_HORIZON ``job_name``
    (``d=<pos> n=<len>`` tokens).

    ``(0, 0)`` when absent or mangled — the advisory is best-effort, so
    a bad payload degrades to "not staged", never to an exception in the
    client message loop.
    """
    kv = parse_stats_kv(job_name)
    pos = kv.get("d", 0)
    n = kv.get("n", 0)
    if not isinstance(pos, int) or not isinstance(n, int) or pos < 0:
        return 0, 0
    return pos, max(n, 0)


def parse_stats_kv(line: str) -> dict:
    """Parse a STATS/PAGING_STATS ``k=v`` line into {key: int|str}.

    The scheduler emits every machine-read field before the (tenant-
    controlled, possibly truncated) holder name, so a trailing mangled
    token parses as a string and never corrupts the numeric fields. The
    canonical parser for ``tpusharectl -s`` output, bench artifacts, and
    ``nvshare_tpu_torch.telemetry.dump``.
    """
    out: dict = {}
    for tok in line.replace("\n", " ").split():
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        if k in out:  # first occurrence wins (spoof-resistance contract)
            continue
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out
