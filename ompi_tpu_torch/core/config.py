"""Typed configuration-variable registry (the port's own copy).

A trimmed copy of the JAX package's registry: every tunable is a
registered, typed variable with one namespace and a fixed precedence

    default  <  file ($OMPI_TPU_PARAM_FILE, then ./ompi-tpu-params.conf)
             <  environment (OMPI_TPU_MCA_<framework>_<name>)

The environment prefix, the file format and the value parsers are the
JAX package's, so one ``OMPI_TPU_MCA_ops_flash_block_q`` or
``OMPI_TPU_MCA_ops_flash_bwd_kernel`` setting reads the same in both.
The port keeps only what its slices read: integer, size, double,
boolean and string variables with an optional allowed-value list; the
file, environment and command-line (``tpurun --mca``, ``load_cli``)
sources; one synonym per framework-selection variable (``--mca btl
self,tcp`` sets ``btl_``); and the programmatic override
``VarRegistry.set`` (no info levels, deprecations or read-only vars).

    default  <  file  <  environment  <  command line  <  set()
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
from typing import Any, Iterable, Optional

__all__ = ["VarType", "Var", "VarRegistry", "var_registry", "register_var"]

#: highest-precedence params file
ENV_PARAM_FILE = "OMPI_TPU_PARAM_FILE"


class VarType(enum.Enum):
    INT = "int"
    SIZE = "size"
    DOUBLE = "double"
    BOOL = "bool"
    STRING = "string"


def _parse_size(s: str) -> int:
    """Sizes with an optional K/M/G suffix (binary units), e.g. '64K'."""
    s = s.strip()
    mult = 1
    if s and s[-1].upper() in "KMG":
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[s[-1].upper()]
        s = s[:-1]
    n = int(float(s) * mult)
    if n < 0:
        raise ValueError(f"size must be >= 0, got {n}")
    return n


def _parse_bool(s: str) -> bool:
    s = s.strip().lower()
    if s in ("1", "true", "yes", "on", "enabled"):
        return True
    if s in ("0", "false", "no", "off", "disabled"):
        return False
    raise ValueError(f"cannot parse {s!r} as bool")


_PARSERS = {VarType.INT: int, VarType.SIZE: _parse_size,
            VarType.DOUBLE: float, VarType.BOOL: _parse_bool,
            VarType.STRING: str}


@dataclasses.dataclass
class Var:
    """One registered configuration variable."""

    framework: str
    name: str
    vtype: VarType
    default: Any
    description: str = ""
    value: Any = None
    #: allowed values of a string variable (None = any)
    enumerator: Optional[tuple] = None
    synonyms: tuple[str, ...] = ()  # alternate full names

    @property
    def full_name(self) -> str:
        return f"{self.framework}_{self.name}" if self.framework else self.name

    def parse(self, raw: str) -> Any:
        value = _PARSERS[self.vtype](raw)
        if self.enumerator is not None and value not in self.enumerator:
            raise ValueError(f"{value!r} is not one of "
                             f"{list(self.enumerator)}")
        return value


class VarRegistry:
    """The process-wide registry; sources apply at registration time."""

    ENV_PREFIX = "OMPI_TPU_MCA_"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._vars: dict[str, Var] = {}
        self._synonyms: dict[str, str] = {}
        self._file: dict[str, str] = {}
        self._cli: dict[str, str] = {}
        self._load_files()

    def _load_files(self) -> None:
        """``name = value`` lines, '#' comments; the first file to define
        a name wins, so paths are listed highest precedence first."""
        paths = [p for p in (os.environ.get(ENV_PARAM_FILE),
                             os.path.join(os.getcwd(),
                                          "ompi-tpu-params.conf")) if p]
        for path in paths:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.split("#", 1)[0].strip()
                        if not line or "=" not in line:
                            continue
                        k, v = (p.strip() for p in line.split("=", 1))
                        self._file.setdefault(k, v)
            except OSError:
                continue

    def _apply(self, var: Var, raw: str, source: str) -> None:
        try:
            var.value = var.parse(raw)
        except ValueError as e:
            raise ValueError(
                f"bad value {raw!r} for {var.vtype.value} variable "
                f"{var.full_name} (from {source}): {e}") from None

    def load_cli(self, pairs: Iterable[tuple[str, str]]) -> None:
        """Record ``--mca name value`` pairs (called by CLI front-ends);
        they win over the file and the environment."""
        with self._lock:
            for name, raw in pairs:
                canon = self._synonyms.get(name, name)
                self._cli[canon] = raw
                var = self._vars.get(canon)
                if var is not None:
                    self._apply(var, raw, "command line")

    def register(self, var: Var) -> Var:
        with self._lock:
            existing = self._vars.get(var.full_name)
            if existing is not None:
                return existing
            var.value = var.default
            self._vars[var.full_name] = var
            names = (var.full_name, *var.synonyms)
            for syn in var.synonyms:
                self._synonyms[syn] = var.full_name
                if syn in self._cli:
                    self._cli.setdefault(var.full_name, self._cli.pop(syn))
            file_raw = next((self._file[n] for n in names
                             if n in self._file), None)
            env_name = next((self.ENV_PREFIX + n for n in names
                             if self.ENV_PREFIX + n in os.environ), None)
            for raw, source in (
                    (file_raw, "file"),
                    (os.environ.get(env_name) if env_name else None,
                     env_name),
                    (self._cli.get(var.full_name), "command line")):
                if raw is not None:
                    self._apply(var, raw, source)
            return var

    def get(self, full_name: str) -> Any:
        with self._lock:
            return self._vars[self._synonyms.get(full_name,
                                                 full_name)].value

    def lookup(self, full_name: str) -> Optional[Var]:
        """The registered variable (a synonym resolves), or None."""
        with self._lock:
            return self._vars.get(self._synonyms.get(full_name, full_name))

    def all_vars(self) -> list[Var]:
        """Every registered variable, by full name (MPI_T's cvars)."""
        with self._lock:
            return sorted(self._vars.values(), key=lambda v: v.full_name)

    def set(self, full_name: str, value: Any) -> None:
        """Programmatic override, above every other source; a string is
        parsed as the environment's would be."""
        with self._lock:
            var = self._vars[full_name]
            var.value = var.parse(value) if isinstance(value, str) else value


var_registry = VarRegistry()


def register_var(framework: str, name: str, vtype: VarType, default: Any,
                 description: str = "",
                 enumerator: Optional[tuple] = None,
                 synonyms: tuple[str, ...] = ()) -> Var:
    return var_registry.register(
        Var(framework=framework, name=name, vtype=vtype, default=default,
            description=description, enumerator=enumerator,
            synonyms=tuple(synonyms)))
