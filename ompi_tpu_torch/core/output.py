"""Logging streams and aggregated user diagnostics (the port's copy of
the JAX package's ``core/output.py``, whole).

Equivalent of ``opal_output`` (opal/util/output.{c,h}) and
``opal_show_help`` (opal/util/show_help.h:32-78):

- ``Stream``: named verbosity-controlled debug streams.  Each stream's
  verbosity is a registered config var (``output_<stream>_verbose``) so it is
  settable via ``--mca``/env/file exactly like the reference's per-framework
  ``*_base_verbose`` params.
- ``show_help``: templated, *deduplicated* user-facing diagnostics.  The
  reference aggregates identical help messages across ranks at the HNP; here
  duplicates within a process are counted and suppressed, and in host process
  mode the launcher aggregates across ranks over the control plane.

Help templates live in ``ompi_tpu_torch/core/help/help-<topic>.txt`` as
``[tag]``-sectioned text files, the reference's format.
"""

from __future__ import annotations

import os
import sys
import threading

__all__ = ["Stream", "get_stream", "show_help", "ShowHelpError", "help_text"]

_lock = threading.RLock()
_streams: dict[str, "Stream"] = {}
_seen_help: dict[tuple, int] = {}
_HELP_DIR = os.path.join(os.path.dirname(__file__), "help")


class Stream:
    """A named output stream with a verbosity level.

    Levels follow the reference convention: 0 = errors/off, higher = chattier.
    ``stream.verbose(level, msg)`` prints only if the stream's configured
    verbosity >= level.
    """

    def __init__(self, name: str, default_verbosity: int = 0) -> None:
        from ompi_tpu_torch.core.config import VarType, register_var

        self.name = name
        self._var = register_var(
            "output", f"{name}_verbose", VarType.INT, default_verbosity,
            description=f"Verbosity for the {name} output stream",
        )

    @property
    def verbosity(self) -> int:
        return self._var.value

    def verbose(self, level: int, msg: str, *args: object) -> None:
        if self.verbosity >= level:
            self._emit(msg % args if args else msg)

    def error(self, msg: str, *args: object) -> None:
        self._emit("ERROR: " + (msg % args if args else msg))

    def emit(self, msg: str, *args: object) -> None:
        """Unconditional output (no verbosity gate, no ERROR prefix) — for
        messages that already passed their own filter (e.g. the notifier's
        severity threshold)."""
        self._emit(msg % args if args else msg)

    def _emit(self, text: str) -> None:
        rank = os.environ.get("OMPI_TPU_RANK")
        prefix = f"[{self.name}" + (f":{rank}" if rank is not None else "") + "] "
        print(prefix + text, file=sys.stderr, flush=True)


def get_stream(name: str, default_verbosity: int = 0) -> Stream:
    with _lock:
        st = _streams.get(name)
        if st is None:
            st = _streams[name] = Stream(name, default_verbosity)
        return st


class ShowHelpError(KeyError):
    pass


def help_text(topic: str, tag: str, **subst: object) -> str:
    """Load ``help-<topic>.txt``, extract the ``[tag]`` section, substitute."""
    path = os.path.join(_HELP_DIR, f"help-{topic}.txt")
    try:
        with open(path) as fh:
            content = fh.read()
    except OSError:
        raise ShowHelpError(f"no help file for topic {topic!r} ({path})")
    lines = content.splitlines()
    out: list[str] = []
    in_section = False
    for line in lines:
        if line.startswith("[") and line.rstrip().endswith("]"):
            if in_section:
                break
            in_section = line.strip() == f"[{tag}]"
            continue
        if in_section:
            out.append(line)
    if not out and not in_section:
        raise ShowHelpError(f"no [{tag}] section in help-{topic}.txt")
    body = "\n".join(out).strip("\n")
    if not subst:
        return body
    try:
        return body % subst
    except (KeyError, ValueError) as e:
        # Template/call-site drift must stay visible, not print raw %(x)s.
        return (body + f"\n[show_help: substitution failed for "
                       f"help-{topic}.txt [{tag}]: {e!r}; args={subst}]")


def show_help(topic: str, tag: str, want_error_header: bool = True,
              **subst: object) -> None:
    """Emit an aggregated user-facing diagnostic (≈ opal_show_help).

    Repeated *identical* diagnostics (same topic, tag, and substitutions) are
    suppressed after the first occurrence and a count is kept;
    ``flush_help_counts`` reports them, mirroring the reference's 'N more
    processes sent this message' aggregation.  Distinct substitutions are
    distinct messages and all print.
    """
    key = (topic, tag, tuple(sorted((k, repr(v)) for k, v in subst.items())))
    with _lock:
        count = _seen_help.get(key, 0)
        _seen_help[key] = count + 1
        if count:
            return
    try:
        body = help_text(topic, tag, **subst)
    except ShowHelpError:
        body = f"(missing help text: topic={topic} tag={tag} args={subst})"
    if want_error_header:
        bar = "-" * 76
        body = f"{bar}\n{body}\n{bar}"
    print(body, file=sys.stderr, flush=True)


def flush_help_counts() -> list[tuple[str, str, int]]:
    """Return and reset suppressed-duplicate counts (launcher calls at exit)."""
    with _lock:
        out = [(k[0], k[1], n - 1) for k, n in _seen_help.items() if n > 1]
        _seen_help.clear()
    return out
