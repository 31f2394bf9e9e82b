"""doctor — the cross-rank collective hang doctor (the port's copy of the
JAX package's ``runtime/doctor.py``, whole; the orted's TAG_DOCTOR
fan-out that calls :func:`query_rank` on a live job comes with the DVM,
ROADMAP.md Queue 1 item 6.15, and ``tools/hang_doctor.py --dir`` reads
crash dumps meanwhile).

The most expensive production question — "my job is stuck: which rank,
in which collective, waiting on whom, and is it a hang or an application
mismatch?" — answered from the collective flight recorder
(``trace.collrec``: every dispatch/round/Start/arena-wait, always on)
plus live per-rank state captures.

Three pieces live here:

- **rank side**: :class:`DoctorResponder`, a tiny UDP server each rank
  arms at ``init()`` (port registered with the job's PMIx server via the
  ``doctor`` RPC).  On a ``cap`` request it replies with
  :func:`capture`: the recorder tail, pending PML sends/recvs
  (peer/tag/cid/bytes/age), live arena arrive/depart counter snapshots
  (the "who hasn't arrived" signal) and every thread's
  ``sys._current_frames`` stack.  It runs on its own daemon thread, so
  a rank wedged in a collective wait still answers — only a fully
  frozen process (SIGSTOP) stays silent, and that silence is itself
  evidence (the owning orted attaches the pid's ``/proc`` state).
- **orted side**: :func:`query_rank` / :func:`proc_probe` — the
  TAG_DOCTOR handler queries each local rank's responder and falls back
  to ``/proc/<pid>`` for non-responders.
- **HNP side**: :func:`analyze` matches records by (cid, op_seq) across
  ranks and produces the machine-readable **verdict**:

  - ``mismatch``  — divergent collective kind (or, for uniform-count
    collectives, divergent signature) at one (cid, op_seq): the
    MUST-class application error that otherwise presents as an opaque
    hang;
  - ``deadlock``  — a cycle in the wait-for graph built from arena
    waits and pending point-to-point state;
  - ``straggler`` — the rank everyone waits on that itself waits on
    nobody (or a frozen pid: ``/proc`` state T/D), named with its
    stack;
  - ``healthy`` / ``no_data`` — nothing wedged / nothing captured.

Import discipline: this is a runtime module — the MPI surface
(``ompi_tpu_torch.mpi.trace``, ``coll.shm``) is imported lazily inside the
rank-side functions only, mirroring runtime/metrics.py's rule.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
import traceback
from collections import Counter
from typing import Any, Optional

from ompi_tpu_torch.core import dss, output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["DoctorResponder", "start_responder", "stop_responder",
           "capture", "query_rank", "query_timeline", "proc_probe",
           "analyze", "thread_stacks", "summarize_rows"]

_log = output.get_stream("doctor")

register_var("doctor", "rows_per_daemon", VarType.INT, 8,
             "full per-rank capture rows each orted sends up per "
             "TAG_DOCTOR round.  Beyond the budget the daemon "
             "pre-aggregates: non-responders, errored ops and the "
             "op_seq extremes (the divergence evidence the analyzer "
             "needs) keep full rows; the healthy middle collapses into "
             "one explicitly-truncated summary row — a 1000-rank "
             "/doctor document stays O(hosts) at the HNP.  0 = "
             "unbounded (every rank a full row)")

register_var("coll", "doctor_enable", VarType.BOOL, True,
             "arm the per-rank hang-doctor responder at init(): a UDP "
             "state-capture endpoint (port registered via the PMIx "
             "'doctor' RPC) the owning orted queries on TAG_DOCTOR — "
             "recorder tail, pending p2p, arena counters, thread "
             "stacks.  Costs one idle daemon thread per rank")

#: responder reply ceiling (UDP datagram with headroom below 64 KiB)
_MAX_REPLY = 60000

#: per-thread stack frame cap and per-stack character cap in a capture
_STACK_FRAMES = 25
_STACK_CHARS = 4000

#: collectives whose payload signature must agree across ranks (the
#: v-variants legitimately pass per-rank counts, so only kind
#: divergence convicts them)
_UNIFORM_SIG_KINDS = frozenset(
    k for base in ("barrier", "bcast", "reduce", "allreduce",
                   "allgather", "alltoall", "scan", "exscan",
                   "reduce_scatter_block")
    for k in (base, f"i{base}", f"p{base}"))

#: pending recvs younger than this are normal traffic, not wait-for
#: evidence (a doctor capture races healthy in-flight messages)
_RECV_EDGE_AGE_S = 0.5


# ---------------------------------------------------------------------------
# rank side: capture + responder
# ---------------------------------------------------------------------------

def thread_stacks(limit: int = _STACK_FRAMES) -> dict[str, str]:
    """Every live thread's formatted stack, keyed by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, str] = {}
    for tid, frame in sys._current_frames().items():
        name = names.get(tid) or f"tid-{tid}"
        text = "".join(traceback.format_stack(frame, limit=limit))
        out[name] = (text[-_STACK_CHARS:] if len(text) > _STACK_CHARS
                     else text)
    return out


def capture(rank: int, jobid: int = 0, pml: Any = None) -> dict:
    """One rank's doctor state: recorder tail, current-op head, pending
    p2p, arena counters, thread stacks.  Best-effort per section — a
    capture must never take a wedged-but-alive rank down."""
    from ompi_tpu_torch.mpi import trace as trace_mod

    trace_mod.count("coll_doctor_captures_total")
    doc: dict[str, Any] = {
        "rank": int(rank), "jobid": int(jobid), "ts": time.time(),
        "pid": os.getpid(),
        "stuck": trace_mod.counters.get("coll_stuck_events_total", 0),
    }
    try:
        doc["collrec"] = [r for r in trace_mod.collrec_tail()
                          if r[1] == rank]
        h = trace_mod.collrec.head
        if h is not None and h[0] == rank:
            cur: dict[str, Any] = {
                "cid": h[1], "seq": h[2],
                "kind": trace_mod.collrec_kind_name(h[3]),
                "age_s": round((time.monotonic_ns() - h[4]) / 1e9, 3),
                "done": bool(h[5]),
            }
            # the head marks err-closed ops done; the analyzer needs
            # the distinction (an err-closed wait KEEPS its wait-for
            # edge — the rank died waiting, it did not finish)
            for rec in reversed(doc["collrec"]):
                if rec[5] == "err" and rec[2] == h[1] and rec[3] == h[2]:
                    cur["err"] = True
                    break
                if rec[5] == "done" and rec[2] == h[1] \
                        and rec[3] == h[2]:
                    break
            doc["cur"] = cur
    except Exception as e:  # noqa: BLE001 — capture survives anything
        doc["collrec_error"] = repr(e)
    if pml is None:
        try:
            from ompi_tpu_torch.mpi import runtime as mpi_runtime

            pml = mpi_runtime._state.get("pml")
        except Exception:  # noqa: BLE001 — no live MPI epoch
            pml = None
    if pml is not None:
        try:
            doc["pending"] = pml.pending_summary()
        except Exception as e:  # noqa: BLE001
            doc["pending_error"] = repr(e)
    try:
        from ompi_tpu_torch.mpi.coll import shm as shm_mod

        arenas = shm_mod.arena_states()
        if arenas:
            doc["arenas"] = arenas
    except Exception as e:  # noqa: BLE001
        doc["arenas_error"] = repr(e)
    try:
        doc["stacks"] = thread_stacks()
    except Exception as e:  # noqa: BLE001
        doc["stacks_error"] = repr(e)
    return doc


class DoctorResponder:
    """The rank-side capture endpoint: one UDP socket + daemon thread.

    Loopback-bound — the querying orted always shares the host with its
    ranks (the same invariant the metrics collector relies on)."""

    def __init__(self, rank: int, jobid: int = 0, pml: Any = None) -> None:
        self.rank = rank
        self.jobid = jobid
        self.pml = pml
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._run, name=f"doctor-resp-{rank}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                blob, addr = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = dss.unpack(blob, n=1)[0]
                if msg[0] not in ("cap", "tl"):
                    continue
                req = msg[0]
                token = int(msg[1]) if len(msg) > 1 else 0
            except Exception:  # noqa: BLE001 — garbage datagram: drop
                continue
            if req == "tl":
                # live-timeline tail: the flight-recorder slice the
                # TAG_TIMELINE fan-out merges into the /timeline trace
                try:
                    tail = int(msg[2]) if len(msg) > 2 else 2048
                    from ompi_tpu_torch.mpi import trace as trace_mod

                    doc = trace_mod.timeline_capture(tail)
                    doc.setdefault("rank", self.rank)
                except Exception as e:  # noqa: BLE001
                    doc = {"rank": self.rank, "error": repr(e)}
                try:
                    self._sock.sendto(self._shrink_tl(token, doc), addr)
                except OSError:
                    pass
                continue
            try:
                doc = capture(self.rank, self.jobid, self.pml)
            except Exception as e:  # noqa: BLE001
                doc = {"rank": self.rank, "error": repr(e)}
            try:
                self._sock.sendto(self._shrink(token, doc), addr)
            except OSError:
                continue

    @staticmethod
    def _shrink(token: int, doc: dict) -> bytes:
        """Pack the reply under the UDP ceiling, dropping the bulkiest
        sections progressively rather than failing the capture."""
        blob = dss.pack(("cap", token, doc))
        if len(blob) <= _MAX_REPLY:
            return blob
        doc = dict(doc)
        full = doc.get("collrec") or []
        doc["collrec"] = full[-64:]
        if len(full) > 64:
            # explicit truncation at EVERY shrink stage: a clipped tail
            # must say so (and how much fell off), never silently pose
            # as the whole recorder history
            doc["collrec_truncated"] = len(full) - 64
        blob = dss.pack(("cap", token, doc))
        if len(blob) <= _MAX_REPLY:
            return blob
        doc["stacks"] = {k: v[-800:]
                         for k, v in (doc.get("stacks") or {}).items()}
        doc["truncated"] = True
        blob = dss.pack(("cap", token, doc))
        if len(blob) <= _MAX_REPLY:
            return blob
        return dss.pack(("cap", token, {
            "rank": doc.get("rank"), "cur": doc.get("cur"),
            "truncated": True}))

    @staticmethod
    def _shrink_tl(token: int, doc: dict) -> bytes:
        """Pack a timeline reply under the UDP ceiling by halving the
        event tail (newest kept) until it fits — a shorter window beats
        a failed capture."""
        blob = dss.pack(("tl", token, doc))
        while len(blob) > _MAX_REPLY:
            events = doc.get("events") or []
            if not events:
                return dss.pack(("tl", token, {
                    "rank": doc.get("rank"), "truncated": True}))
            doc = dict(doc)
            doc["events"] = events[-(len(events) // 2):]
            doc["truncated"] = True
            blob = dss.pack(("tl", token, doc))
        return blob

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


_responder: Optional[DoctorResponder] = None
_resp_lock = threading.Lock()


def start_responder(rank: int, jobid: int = 0, pml: Any = None,
                    client: Any = None) -> Optional[DoctorResponder]:
    """Arm the rank's doctor responder (idempotent; no-op when
    ``coll_doctor_enable`` is off).  ``client`` — the rank's PMIxClient —
    registers the port with the control plane so the owning orted can
    find it."""
    global _responder
    try:
        if not var_registry.get("coll_doctor_enable"):
            return None
    except Exception:  # noqa: BLE001 — unregistered knob: stay armed
        pass
    with _resp_lock:
        if _responder is None:
            _responder = DoctorResponder(rank, jobid=jobid, pml=pml)
        resp = _responder
    if client is not None:
        try:
            client.register_doctor(resp.port)
        except Exception as e:  # noqa: BLE001 — observability, not init
            _log.verbose(1, "doctor port registration failed: %r", e)
    return resp


def stop_responder() -> None:
    global _responder
    with _resp_lock:
        resp, _responder = _responder, None
    if resp is not None:
        resp.close()


# ---------------------------------------------------------------------------
# orted side: query one local rank / probe a frozen pid
# ---------------------------------------------------------------------------

def query_rank(port: int, timeout: float = 0.8) -> Optional[dict]:
    """One capture from a local rank's responder (None on silence — a
    SIGSTOP'd rank cannot answer, which is evidence in itself)."""
    token = time.monotonic_ns() & 0x7FFFFFFF
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.settimeout(timeout)
        sock.sendto(dss.pack(("cap", token)), ("127.0.0.1", int(port)))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                blob, _addr = sock.recvfrom(1 << 16)
            except socket.timeout:
                return None
            try:
                msg = dss.unpack(blob, n=1)[0]
            except Exception:  # noqa: BLE001
                continue
            if msg[0] == "cap" and int(msg[1]) == token:
                return dict(msg[2])
        return None
    except OSError:
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass


def query_timeline(port: int, tail: int = 2048,
                   timeout: float = 0.8) -> Optional[dict]:
    """One flight-recorder tail from a local rank's responder (None on
    silence) — the TAG_TIMELINE analog of :func:`query_rank`."""
    token = time.monotonic_ns() & 0x7FFFFFFF
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.settimeout(timeout)
        sock.sendto(dss.pack(("tl", token, int(tail))),
                    ("127.0.0.1", int(port)))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                blob, _addr = sock.recvfrom(1 << 16)
            except socket.timeout:
                return None
            try:
                msg = dss.unpack(blob, n=1)[0]
            except Exception:  # noqa: BLE001
                continue
            if msg[0] == "tl" and int(msg[1]) == token:
                return dict(msg[2])
        return None
    except OSError:
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass


def proc_probe(pid: int) -> dict:
    """Kernel-side evidence for a rank that did not answer: /proc state
    (T = stopped — the SIGSTOP signature), wchan and current syscall."""
    out: dict[str, Any] = {"pid": int(pid)}
    try:
        with open(f"/proc/{pid}/stat") as f:
            out["state"] = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        out["state"] = "?"
    for name in ("wchan", "syscall"):
        try:
            with open(f"/proc/{pid}/{name}") as f:
                val = f.read(160).strip()
            if val:
                out[name] = val
        except OSError:
            continue
    return out


def summarize_rows(rows: list[dict],
                   limit: int) -> tuple[list[dict], Optional[dict]]:
    """Hierarchical doctor pre-aggregation, the orted half: bound one
    daemon's TAG_DOCTOR_REPLY to ``limit`` full per-rank rows plus ONE
    summary row for everyone else — so a fleet-wide capture costs the
    HNP O(hosts · limit), not O(ranks).

    Which rows keep full fidelity is chosen for the analyzer's benefit:
    non-responders and errored ops always (they decide deadlock /
    straggler verdicts), then the op_seq extremes of the rest (the
    slowest and fastest ranks ARE the divergence evidence a mismatch /
    straggler verdict needs; the agreeing middle of the distribution is
    what compresses).  The summary row is explicitly marked
    (``summary``/``truncated``) and carries the omitted ranks' aggregate
    shape — count, current-op kind histogram, op_seq min/max, a bounded
    rank sample — so the /doctor document SAYS what it dropped.

    Returns ``(kept_rows, summary_row_or_None)``; a row set within the
    budget (or ``limit <= 0`` = unbounded) passes through untouched."""
    rows = list(rows)
    if limit <= 0 or len(rows) <= limit:
        return rows, None

    def cur_of(c: dict) -> dict:
        return c.get("cur") or _pushed_cur(c) or {}

    def seq_of(c: dict) -> int:
        try:
            return int(cur_of(c).get("seq", -1))
        except (TypeError, ValueError):
            return -1

    hot = [i for i, c in enumerate(rows)
           if c.get("no_response") or cur_of(c).get("err")]
    keep = set(hot[:limit])
    room = limit - len(keep)
    if room > 0:
        cold = sorted((i for i in range(len(rows)) if i not in keep),
                      key=lambda i: (seq_of(rows[i]), i))
        n_head = (room + 1) // 2
        keep.update(cold[:n_head])
        keep.update(cold[max(n_head, len(cold) - (room - n_head)):])
    kept = [rows[i] for i in sorted(keep)]
    omitted = [rows[i] for i in range(len(rows)) if i not in keep]
    kinds: Counter = Counter()
    seqs: list[int] = []
    stuck = 0
    for c in omitted:
        cur = cur_of(c)
        if cur:
            kinds[str(cur.get("kind", "?"))] += 1
        s = seq_of(c)
        if s >= 0:
            seqs.append(s)
        try:
            stuck += int(bool(c.get("stuck")))
        except (TypeError, ValueError):
            pass
    sample = sorted(int(c.get("rank", -1)) for c in omitted)[:32]
    summary = {
        "summary": True, "truncated": True,
        "ranks_omitted": len(omitted),
        "rank_sample": sample,
        "cur_kinds": dict(kinds),
        "op_seq_min": (min(seqs) if seqs else None),
        "op_seq_max": (max(seqs) if seqs else None),
        "stuck": stuck,
    }
    return kept, summary


# ---------------------------------------------------------------------------
# HNP side: the analyzer
# ---------------------------------------------------------------------------

def _kind_name(kind_id: Any) -> str:
    from ompi_tpu_torch.mpi import trace as trace_mod

    try:
        return trace_mod.collrec_kind_name(int(kind_id))
    except (TypeError, ValueError):
        return "?"


def _pushed_cur(c: dict) -> Optional[dict]:
    """A non-responder's last uplink-pushed recorder head, normalized to
    the responder ``cur`` shape."""
    pushed = c.get("pushed") or {}
    if "coll_cur_seq" not in pushed or pushed["coll_cur_seq"] < 0:
        return None
    ts = float(pushed.get("coll_cur_posted_ts", 0.0))
    return {
        "cid": int(pushed.get("coll_cur_cid", -1)),
        "seq": int(pushed["coll_cur_seq"]),
        "kind": _kind_name(pushed.get("coll_cur_kind_id", -1)),
        "age_s": (round(max(0.0, time.time() - ts), 3) if ts > 0
                  else 0.0),
        "done": bool(pushed.get("coll_cur_done", 0)),
        "pushed": True,
    }


def _rank_posts(c: dict) -> dict[tuple[int, int], tuple[str, Optional[int]]]:
    """(cid, op_seq) → (kind, sig) from one capture's recorder tail
    (plus the pushed head for non-responders).  Records are filtered to
    the capture's own rank: a tail from a process hosting several ranks
    (the in-process test harness) must not smear one rank's posts over
    another's and mask a divergence."""
    own = int(c.get("rank", -1))
    out: dict[tuple[int, int], tuple[str, Optional[int]]] = {}
    for rec in c.get("collrec") or []:
        try:
            _ts, r, cid, seq, kind, phase, sig = rec[:7]
        except (TypeError, ValueError):
            continue
        if int(r) != own:
            continue
        if phase == "post" and seq >= 0:
            out[(int(cid), int(seq))] = (str(kind), int(sig))
    cur = c.get("cur") or _pushed_cur(c)
    if cur is not None and cur.get("seq", -1) >= 0:
        out.setdefault((int(cur.get("cid", -1)), int(cur["seq"])),
                       (str(cur.get("kind", "?")), None))
    return out


def _rank_cur(c: dict) -> Optional[dict]:
    return c.get("cur") or _pushed_cur(c)


def _wait_edges(c: dict) -> set[int]:
    """Ranks this capture's rank is provably waiting on: the newest
    un-closed arena wait record, plus aged pending named-source recvs."""
    edges: set[int] = set()
    cur = _rank_cur(c)
    if cur is not None and (not cur.get("done") or cur.get("err")):
        # newest wait record for the in-flight (cid, seq); an op closed
        # by "err" (coll_shm_timeout killed the wait) keeps its edge —
        # a failed wait is the postmortem's strongest wait-for evidence
        for rec in reversed(c.get("collrec") or []):
            try:
                _ts, r, cid, seq, _kind, phase, _sig, info = rec[:8]
            except (TypeError, ValueError):
                continue
            if int(r) != int(c.get("rank", -1)):
                continue
            if phase == "done" and int(cid) == int(cur.get("cid", -2)) \
                    and int(seq) == int(cur["seq"]):
                break   # that op closed after its waits
            if phase in ("wait", "stuck") \
                    and int(cid) == int(cur.get("cid", -2)) \
                    and int(seq) == int(cur["seq"]) \
                    and isinstance(info, dict) and "on" in info:
                edges.add(int(info["on"]))
                break
    pending = c.get("pending") or {}
    for rv in pending.get("recvs") or []:
        try:
            if rv["src"] >= 0 and rv.get("age_s", 0) >= _RECV_EDGE_AGE_S:
                edges.add(int(rv["src"]))
        except (TypeError, KeyError):
            continue
    edges.discard(int(c.get("rank", -1)))
    return edges


def _find_cycle(edges: dict[int, set[int]]) -> Optional[list[int]]:
    """First cycle in the wait-for graph (DFS, deterministic order)."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {r: WHITE for r in edges}
    stack: list[int] = []

    def dfs(r: int) -> Optional[list[int]]:
        color[r] = GREY
        stack.append(r)
        for t in sorted(edges.get(r, ())):
            if color.get(t, WHITE) == GREY:
                return stack[stack.index(t):] + [t]
            if color.get(t, WHITE) == WHITE and t in edges:
                found = dfs(t)
                if found:
                    return found
        stack.pop()
        color[r] = BLACK
        return None

    for r in sorted(edges):
        if color[r] == WHITE:
            found = dfs(r)
            if found:
                return found
    return None


def analyze(captures: list[dict],
            nranks: Optional[int] = None) -> dict:
    """The cross-rank verdict from per-rank captures (responders and
    ``no_response`` /proc probes alike).  Pure function of its inputs —
    shared by the live DVM ``/doctor`` endpoint and the offline
    ``tools/hang_doctor.py`` crash-dump mode."""
    by_rank: dict[int, dict] = {}
    for c in captures or []:
        try:
            by_rank[int(c["rank"])] = c
        except (TypeError, KeyError, ValueError):
            continue
    doc: dict[str, Any] = {
        "nranks": nranks if nranks is not None else len(by_rank),
        "responders": sorted(r for r, c in by_rank.items()
                             if not c.get("no_response")),
        "no_response": sorted(r for r, c in by_rank.items()
                              if c.get("no_response")),
        "ranks": {},
    }
    for r, c in sorted(by_rank.items()):
        row: dict[str, Any] = {}
        cur = _rank_cur(c)
        if cur is not None:
            row["cur"] = cur
        if c.get("no_response"):
            row["no_response"] = True
            if "proc" in c:
                row["proc"] = c["proc"]
        doc["ranks"][str(r)] = row
    if not by_rank:
        doc["verdict"] = {"kind": "no_data",
                          "detail": "no rank state captured"}
        return doc

    # -- 1. collective mismatch: divergent (kind | uniform-count sig)
    #       at one (cid, op_seq) -----------------------------------------
    posts: dict[tuple[int, int], dict[int, tuple[str, Optional[int]]]] = {}
    for r, c in by_rank.items():
        for key, val in _rank_posts(c).items():
            posts.setdefault(key, {})[r] = val
    for (cid, seq) in sorted(posts):
        ranks = posts[(cid, seq)]
        if len(ranks) < 2:
            continue
        kinds = {k for k, _s in ranks.values()}
        divergent_sig = False
        if len(kinds) == 1 and next(iter(kinds)) in _UNIFORM_SIG_KINDS:
            sigs = {s for _k, s in ranks.values() if s is not None}
            divergent_sig = len(sigs) > 1
        if len(kinds) > 1 or divergent_sig:
            if len(kinds) > 1:
                majority, _n = Counter(
                    k for k, _s in ranks.values()).most_common(1)[0]
                culprits = sorted(r for r, (k, _s) in ranks.items()
                                  if k != majority)
            else:
                # kinds agree, signatures diverge: the minority
                # SIGNATURE holder is the culprit
                maj_sig, _n = Counter(
                    s for _k, s in ranks.values()
                    if s is not None).most_common(1)[0]
                culprits = sorted(r for r, (_k, s) in ranks.items()
                                  if s is not None and s != maj_sig)
            culprits = culprits or sorted(ranks)
            doc["verdict"] = {
                "kind": "mismatch",
                "cid": cid, "op_seq": seq,
                "rank": culprits[0],
                "ranks": culprits,
                "kinds": {str(r): k for r, (k, _s) in
                          sorted(ranks.items())},
                "detail": (
                    f"collective mismatch at (cid {cid}, op_seq {seq}): "
                    + ("divergent kinds "
                       + ", ".join(f"rank {r}={k}" for r, (k, _s)
                                   in sorted(ranks.items()))
                       if len(kinds) > 1 else
                       f"divergent payload signatures on "
                       f"{next(iter(kinds))} (dtype/count/root "
                       f"disagree across ranks)")),
            }
            stack = (by_rank.get(culprits[0], {})
                     .get("stacks") or {}).get("MainThread")
            if stack:
                doc["verdict"]["stack"] = stack
            return doc

    # -- 2. deadlock: a cycle in the wait-for graph ----------------------
    edges = {r: _wait_edges(c) for r, c in by_rank.items()
             if not c.get("no_response")}
    edges = {r: e for r, e in edges.items() if e}
    cycle = _find_cycle(edges)
    if cycle:
        doc["verdict"] = {
            "kind": "deadlock",
            "cycle": cycle,
            "rank": min(cycle[:-1]),
            "detail": ("wait-for cycle: "
                       + " -> ".join(str(r) for r in cycle)),
            "stacks": {str(r): (by_rank.get(r, {}).get("stacks") or {})
                       .get("MainThread", "")[-1500:]
                       for r in cycle[:-1]},
        }
        return doc

    # -- 3. straggler: the rank everyone waits on that waits on nobody --
    waited_on: Counter = Counter(t for targets in edges.values()
                                 for t in targets)
    suspect: Optional[int] = None
    why = ""
    frozen = [r for r, c in by_rank.items()
              if c.get("no_response")
              and (c.get("proc") or {}).get("state") in ("T", "t", "D")]
    if frozen:
        suspect = (max(frozen, key=lambda r: waited_on.get(r, 0))
                   if waited_on else frozen[0])
        st = (by_rank[suspect].get("proc") or {}).get("state")
        why = (f"pid frozen (/proc state {st!r}"
               + (", SIGSTOP signature)" if st in ("T", "t")
                  else ", uninterruptible)"))
    elif waited_on:
        def _gave_up(r: int) -> bool:
            cur = _rank_cur(by_rank.get(r, {}))
            return bool(cur and cur.get("err"))

        cand = [r for r, _n in waited_on.most_common()
                if not edges.get(r)]
        if cand:
            # among waited-on ranks that wait on nobody, one still
            # wedged in flight beats one that already erred out — the
            # err'd ranks are victims of the hang, not its cause
            alive = [r for r in cand if not _gave_up(r)]
            suspect = (alive or cand)[0]
            why = (f"{waited_on[suspect]} rank(s) wait on it "
                   f"(transitively); it waits on nobody")
        else:
            suspect, n = waited_on.most_common(1)[0]
            why = f"most-waited-on rank ({n} waiters)"
    else:
        # no wait evidence: the rank whose op_seq frontier is lowest
        # while peers moved on (a silently slow/stopped rank)
        curs = {r: _rank_cur(c) for r, c in by_rank.items()}
        inflight = {r: c for r, c in curs.items()
                    if c is not None and not c.get("done")}
        if inflight and len({c["seq"] for c in inflight.values()}) > 1:
            suspect = min(inflight, key=lambda r: inflight[r]["seq"])
            why = (f"behind the op_seq frontier "
                   f"(at {inflight[suspect]['seq']}, peers ahead)")
    if suspect is not None:
        verdict: dict[str, Any] = {
            "kind": "straggler", "rank": suspect, "detail": (
                f"rank {suspect} is the straggler: {why}"),
            "waiters": {str(r): sorted(t)
                        for r, t in sorted(edges.items())},
        }
        c = by_rank.get(suspect, {})
        cur = _rank_cur(c)
        if cur is not None:
            verdict["cid"] = cur.get("cid")
            verdict["op_seq"] = cur.get("seq")
            verdict["in"] = cur.get("kind")
        stacks = c.get("stacks")
        if stacks:
            verdict["stack"] = (stacks.get("MainThread")
                                or next(iter(stacks.values()), ""))
        elif "proc" in c:
            verdict["proc"] = c["proc"]
        doc["verdict"] = verdict
        return doc

    # -- 4. nothing wedged ----------------------------------------------
    curs = [(_rank_cur(c) or {}) for c in by_rank.values()]
    if any(cur and not cur.get("done") for cur in curs):
        doc["verdict"] = {
            "kind": "healthy",
            "detail": "collectives in flight, no wedge evidence "
                      "(capture may have raced normal progress)"}
    else:
        doc["verdict"] = {"kind": "healthy",
                          "detail": "no collective in flight"}
    return doc
