"""The repo linter's own checker proofs (``tests/tools/test_lint_checkers.py``,
all 49) run on the port's copy of it, ``ompi_tpu_torch.tools.lint``
(``tests/torch_mirror.py`` maps ``tools.lint`` and the ``python -m
tools.lint`` the driver cases launch): every checker catches its bad
fixture and stays silent on its clean one, the baseline and driver
cases hold, and the full-tree gate runs ``python -m
ompi_tpu_torch.tools.lint --no-mypy -q`` over the port, which must exit
0 with the port's empty baseline.
"""

from __future__ import annotations

import json
import pathlib

import pytest

import tests.tools.test_lint_checkers as ref_lint
from tests.torch_mirror import cases, run_case

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_every_checker_case_is_mirrored():
    assert len(cases(ref_lint)) == 49


@pytest.mark.parametrize("name,params", cases(ref_lint))
def test_lint_case_on_the_ports_lint(name, params, request):
    run_case(ref_lint, name, params, True, request, [])


def test_the_ports_lint_indexes_the_port_alone():
    """The full-tree run indexes ``ompi_tpu_torch`` less its own lint
    package (whose fixtures are bad on purpose), its baseline is empty,
    and its mypy surface is the port's typed core."""
    from ompi_tpu_torch.tools.lint import driver
    from ompi_tpu_torch.tools.lint.baseline import DEFAULT_PATH
    from ompi_tpu_torch.tools.lint.index import ProjectIndex

    assert driver._repo_root() == str(ROOT)
    assert driver.DEFAULT_PACKAGES == ["ompi_tpu_torch"]
    assert json.loads(pathlib.Path(DEFAULT_PATH).read_text()) == {
        "findings": []}
    for path in driver.STRICT_SURFACE:
        assert path.startswith("ompi_tpu_torch/") and (ROOT / path).exists()
    idx = ProjectIndex.build(str(ROOT), packages=driver.DEFAULT_PACKAGES,
                             exclude=driver.DEFAULT_EXCLUDE)
    names = set(idx.modules)
    assert "ompi_tpu_torch.mpi.pml" in names
    assert not any(n.startswith(("ompi_tpu.", "tools.")) for n in names)
    assert not any(n.startswith("ompi_tpu_torch.tools.lint") for n in names)
