"""Component/framework registry — the Modular Component Architecture (the
port's trimmed copy of the JAX package's ``core/mca.py``).

The reference's uniform plugin system (opal/mca/mca.h:281-343,
opal/mca/base/mca_base_framework.h:127-157, mca_base_components_select.c):
every subsystem is a *framework* (a fixed interface) holding N
*components* (implementations), selected at run time by priority and the
user's directive.  Components register with a class decorator at import
time.

The directive is the configuration variable ``<framework>_`` (empty name),
read through the port's ``core/config.py`` (with the bare framework name
as its synonym), so ``OMPI_TPU_MCA_coll_=^xla`` and ``--mca coll ^xla``
read the same in both packages:

- ``""``      → every component eligible, highest ``query()`` first
- ``"xla"``   → only the listed component(s) (a missing one raises)
- ``"^xla"``  → all but the listed components
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Type

from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["Component", "Framework", "ComponentError"]


class ComponentError(RuntimeError):
    pass


class Component:
    """Base class for all components (≈ mca_base_component_2_1_0_t).

    Subclasses set ``NAME`` and ``PRIORITY``.  ``query()`` returns the
    priority, or None to decline selection in this context (≈
    mca_query_component returning OMPI_ERR_NOT_AVAILABLE).
    """

    NAME: str = ""
    PRIORITY: int = 0
    FRAMEWORK: str = ""  # filled in by Framework.component()

    def register_params(self) -> None:
        """Register this component's config vars (≈
        mca_register_component_params)."""

    def query(self, **context: Any) -> Optional[int]:
        """Return selection priority for this context, or None to decline."""
        return self.PRIORITY


class Framework:
    """A plugin slot: fixed interface, N components, priority selection."""

    def __init__(self, name: str, description: str = "") -> None:
        self.name = name
        self.description = description
        self._components: dict[str, Component] = {}
        self._lock = threading.RLock()
        register_var(
            name, "", VarType.STRING, "",
            description=f"Component selection for the {name} framework "
                        f"(comma list; prefix with ^ to exclude)",
            synonyms=(name,))

    def component(self, cls: Type[Component]) -> Type[Component]:
        """Class decorator registering a component with this framework."""
        if not cls.NAME:
            raise ComponentError(f"component {cls!r} has no NAME")
        cls.FRAMEWORK = self.name
        with self._lock:
            if cls.NAME in self._components:
                raise ComponentError(
                    f"duplicate component {self.name}/{cls.NAME}")
            inst = cls()
            inst.register_params()
            self._components[cls.NAME] = inst
        return cls

    # -- selection ------------------------------------------------------

    def _directive(self) -> tuple[set[str], bool]:
        """Parse the selection variable → (names, is_exclude)."""
        raw = (var_registry.get(f"{self.name}_") or "").strip()
        if not raw:
            return set(), True  # exclude-nothing == everything eligible
        if raw.startswith("^"):
            return {s.strip() for s in raw[1:].split(",") if s.strip()}, True
        return {s.strip() for s in raw.split(",") if s.strip()}, False

    def _eligible(self) -> list[Component]:
        names, is_exclude = self._directive()
        with self._lock:
            components = dict(self._components)
        comps = [comp for name, comp in components.items()
                 if (name not in names) == is_exclude]
        if not is_exclude:
            missing = names - set(components)
            if missing:
                raise ComponentError(
                    f"requested {self.name} component(s) not found: "
                    f"{sorted(missing)} (the {self.name} framework has: "
                    f"{', '.join(sorted(components))}; check the "
                    f"{self.name}_ selection directive)")
        return comps

    def select(self, **context: Any) -> Component:
        """Pick the single highest-priority component that accepts
        ``context``."""
        best = self.select_all(**context)
        if not best:
            raise ComponentError(
                f"no {self.name} component available for context "
                f"{context!r}")
        return best[0]

    def select_all(self, **context: Any) -> list[Component]:
        """All accepting components, highest priority first (for stacked
        frameworks like coll where modules layer per-function)."""
        scored: list[tuple[int, Component]] = []
        for comp in self._eligible():
            pri = comp.query(**context)
            if pri is None:
                continue
            scored.append((pri, comp))
        scored.sort(key=lambda pc: (-pc[0], pc[1].NAME))
        return [c for _, c in scored]

    def components(self) -> dict[str, Component]:
        with self._lock:
            return dict(self._components)
