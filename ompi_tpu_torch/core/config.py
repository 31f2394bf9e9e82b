"""Typed configuration-variable registry (the port's own copy).

The port's copy of the JAX package's registry (≈ the reference's MCA
variable system, opal/mca/base/mca_base_var.h:78-96,404-475;
mca_base_var.c): every tunable is a registered, typed, self-describing
variable with one namespace and a fixed source precedence

    default  <  file (~/.ompi_tpu/params.conf < ./ompi-tpu-params.conf
                      < $OMPI_TPU_PARAM_FILE)
             <  environment (OMPI_TPU_MCA_<framework>_<name>)
             <  command line (--mca <framework>_<name> <value>)
             <  programmatic set_var()

Each variable records the source its value came from (``VarSource``),
carries an info level (``InfoLevel``, the audience ``tools/info.py
--level`` filters on), and may be read-only (an external setting is
ignored with a warning, ``set()`` raises), deprecated (a setting from
any source but the default warns once) or known under synonyms (the
framework-selection variable ``btl_`` is also ``btl``, so ``--mca btl
self,tcp`` sets it).  The environment prefix, the file format and the
value parsers are the JAX package's, so one
``OMPI_TPU_MCA_ops_flash_bwd_kernel`` setting reads the same in both,
and so does a line of the user's ``~/.ompi_tpu/params.conf``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import sys
import threading
from typing import Any, Callable, Iterable, Optional

__all__ = ["VarType", "VarSource", "InfoLevel", "Var", "VarRegistry",
           "var_registry", "register_var", "get_var", "set_var"]

#: highest-precedence params file
ENV_PARAM_FILE = "OMPI_TPU_PARAM_FILE"


class VarType(enum.Enum):
    INT = "int"
    UNSIGNED = "unsigned"
    SIZE = "size"
    STRING = "string"
    BOOL = "bool"
    DOUBLE = "double"
    # list of strings (comma separated in env/CLI)
    STRING_LIST = "string_list"


class VarSource(enum.Enum):
    """Where the current value came from (precedence low→high)."""

    DEFAULT = 0
    FILE = 1
    ENV = 2
    COMMAND_LINE = 3
    SET = 4  # programmatic override — wins over everything


class InfoLevel(enum.IntEnum):
    """Audience levels, mirroring MCA_BASE_VAR_INFO_LVL_* (mca_base_var.h)."""

    USER_BASIC = 1
    USER_DETAIL = 2
    USER_ALL = 3
    TUNER_BASIC = 4
    TUNER_DETAIL = 5
    TUNER_ALL = 6
    DEV_BASIC = 7
    DEV_DETAIL = 8
    DEV_ALL = 9


def _nonneg(v: int) -> int:
    if v < 0:
        raise ValueError(f"negative value {v} for unsigned variable")
    return v


def _parse_size(s: str) -> int:
    """Sizes with an optional K/M/G suffix (binary units), e.g. '64K'."""
    s = s.strip()
    mult = 1
    if s and s[-1].upper() in "KMG":
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[s[-1].upper()]
        s = s[:-1]
    return _nonneg(int(float(s) * mult))


def _parse_bool(s: str) -> bool:
    s = s.strip().lower()
    if s in ("1", "true", "yes", "on", "enabled"):
        return True
    if s in ("0", "false", "no", "off", "disabled"):
        return False
    raise ValueError(f"cannot parse {s!r} as bool")


_PARSERS: dict[VarType, Callable[[str], Any]] = {
    VarType.INT: int,
    VarType.UNSIGNED: lambda s: _nonneg(int(s)),
    VarType.SIZE: _parse_size,
    VarType.STRING: str,
    VarType.BOOL: _parse_bool,
    VarType.DOUBLE: float,
    VarType.STRING_LIST: lambda s: [p for p in (t.strip()
                                                for t in s.split(",")) if p],
}


@dataclasses.dataclass
class Var:
    """One registered configuration variable."""

    framework: str
    name: str
    vtype: VarType
    default: Any
    description: str = ""
    info_level: InfoLevel = InfoLevel.USER_ALL
    read_only: bool = False
    deprecated: bool = False
    #: allowed values (None = any)
    enumerator: Optional[tuple] = None
    synonyms: tuple[str, ...] = ()  # alternate full names
    # current state
    value: Any = None
    source: VarSource = VarSource.DEFAULT

    @property
    def full_name(self) -> str:
        return f"{self.framework}_{self.name}" if self.framework else self.name

    def parse(self, raw: str) -> Any:
        v = _PARSERS[self.vtype](raw)
        self._check(v)
        return v

    def _check(self, v: Any) -> None:
        if self.enumerator is not None and v not in self.enumerator:
            raise ValueError(
                f"value {v!r} for {self.full_name} not in {self.enumerator}")


class VarRegistry:
    """The process-wide registry with its source precedence.

    Sources are applied at registration time (so late registration still
    sees CLI/env/file settings, as mca_base_var re-scans its file/env
    caches in mca_base_var_register).
    """

    ENV_PREFIX = "OMPI_TPU_MCA_"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._vars: dict[str, Var] = {}
        self._synonyms: dict[str, str] = {}
        # pending settings keyed by the name they were given under
        self._pending: dict[str, tuple[str, VarSource]] = {}
        self._warned: set[str] = set()
        self._load_files()

    # -- source loading -------------------------------------------------

    def _load_files(self) -> None:
        """``name = value`` lines, '#' comments (the reference's
        mca_base_parse_paramfile.c); the first file to define a name
        wins, so paths are listed highest precedence first:
        ``$OMPI_TPU_PARAM_FILE``, ``./ompi-tpu-params.conf``,
        ``~/.ompi_tpu/params.conf``."""
        paths = [p for p in (os.environ.get(ENV_PARAM_FILE),
                             os.path.join(os.getcwd(),
                                          "ompi-tpu-params.conf"),
                             os.path.join(os.path.expanduser("~"),
                                          ".ompi_tpu", "params.conf")) if p]
        for path in paths:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.split("#", 1)[0].strip()
                        if not line or "=" not in line:
                            continue
                        k, v = (p.strip() for p in line.split("=", 1))
                        self._pending.setdefault(k, (v, VarSource.FILE))
            except OSError:
                continue

    def load_cli(self, pairs: Iterable[tuple[str, str]]) -> None:
        """Record ``--mca name value`` pairs (called by CLI front-ends)."""
        with self._lock:
            for name, raw in pairs:
                self._pending[name] = (raw, VarSource.COMMAND_LINE)
                canon = self._synonyms.get(name, name)
                var = self._vars.get(canon)
                if var is not None:
                    self._apply(var, raw, VarSource.COMMAND_LINE)

    # -- registration ---------------------------------------------------

    def register(self, var: Var) -> Var:
        with self._lock:
            existing = self._vars.get(var.full_name)
            if existing is not None:
                return existing
            var.value = var.default
            self._vars[var.full_name] = var
            for syn in var.synonyms:
                self._synonyms[syn] = var.full_name
            # file < env < cli; among the canonical name and its synonyms
            # the highest-precedence source wins (a CLI setting under a
            # synonym beats a file setting under the canonical name)
            pend: Optional[tuple[str, VarSource]] = None
            for cand in (var.full_name, *var.synonyms):
                p = self._pending.get(cand)
                if p is not None and (pend is None
                                      or p[1].value > pend[1].value):
                    pend = p
            if pend is not None and pend[1] == VarSource.FILE:
                self._apply(var, pend[0], VarSource.FILE)
            env_raw = os.environ.get(self.ENV_PREFIX + var.full_name)
            for syn in var.synonyms:
                if env_raw is None:
                    env_raw = os.environ.get(self.ENV_PREFIX + syn)
            if env_raw is not None:
                self._apply(var, env_raw, VarSource.ENV)
            if pend is not None and pend[1] == VarSource.COMMAND_LINE:
                self._apply(var, pend[0], VarSource.COMMAND_LINE)
            return var

    def _warn(self, var: Var, msg: str) -> None:
        if var.full_name not in self._warned:
            self._warned.add(var.full_name)
            print(f"ompi_tpu_torch: {msg}", file=sys.stderr)

    def _apply(self, var: Var, raw: str, source: VarSource) -> None:
        if var.read_only and source != VarSource.DEFAULT:
            # an external setting on a read-only var is ignored with a
            # warning, never an import-time crash (as the reference)
            print(f"ompi_tpu_torch: ignoring {source.name.lower()} override "
                  f"of read-only variable {var.full_name}", file=sys.stderr)
            return
        try:
            var.value = var.parse(raw)
        except ValueError as e:
            hint = (self.ENV_PREFIX + var.full_name
                    if source == VarSource.ENV else source.name.lower())
            raise ValueError(
                f"bad value {raw!r} for {var.vtype.value} variable "
                f"{var.full_name} (from {hint}): {e}") from None
        var.source = source
        if var.deprecated:
            self._warn(var, f"variable {var.full_name} is deprecated "
                            f"(set from {source.name.lower()})")

    # -- access ---------------------------------------------------------

    def get(self, full_name: str) -> Any:
        with self._lock:
            canon = self._synonyms.get(full_name, full_name)
            return self._vars[canon].value

    def lookup(self, full_name: str) -> Optional[Var]:
        """The registered variable (a synonym resolves), or None."""
        with self._lock:
            canon = self._synonyms.get(full_name, full_name)
            return self._vars.get(canon)

    def set(self, full_name: str, value: Any) -> None:
        """Programmatic override (highest precedence); a string is parsed
        as the environment's would be."""
        with self._lock:
            canon = self._synonyms.get(full_name, full_name)
            var = self._vars[canon]
            if var.read_only:
                raise ValueError(f"variable {full_name} is read-only")
            if isinstance(value, str) and var.vtype != VarType.STRING:
                value = var.parse(value)
            else:
                var._check(value)
            var.value = value
            var.source = VarSource.SET
            if var.deprecated:
                self._warn(var, f"variable {var.full_name} is deprecated")

    def all_vars(self) -> list[Var]:
        """Every registered variable, by full name (MPI_T's cvars)."""
        with self._lock:
            return sorted(self._vars.values(), key=lambda v: v.full_name)

    def dump(self, max_level: InfoLevel = InfoLevel.DEV_ALL) -> str:
        lines: list[str] = []
        for var in self.all_vars():
            if var.info_level > max_level:
                continue
            lines.append(
                f"{var.full_name} = {var.value!r}  "
                f"[{var.vtype.value}, {var.source.name.lower()}]"
                + (f"  # {var.description}" if var.description else ""))
        return "\n".join(lines)


var_registry = VarRegistry()


def register_var(framework: str, name: str, vtype: VarType | str,
                 default: Any, description: str = "", **kw: Any) -> Var:
    if isinstance(vtype, str):
        vtype = VarType(vtype)
    if "synonyms" in kw:
        kw["synonyms"] = tuple(kw["synonyms"])
    return var_registry.register(
        Var(framework=framework, name=name, vtype=vtype, default=default,
            description=description, **kw))


def get_var(full_name: str) -> Any:
    return var_registry.get(full_name)


def set_var(full_name: str, value: Any) -> None:
    var_registry.set(full_name, value)
