"""The port's DVM observability plane in process: the ``scrape_hnp``
cases of ``tests/runtime/test_obs_plane.py`` (``/metrics``, ``/status``,
404, one ``# TYPE`` line a name, the straggler panel, histogram series,
and the ``--dvm-ps`` proc rows' lives, p99 and rejoin columns), each the
JAX package's own body run through ``tests/torch_mirror.py`` against a
port ``DvmHnp`` serving its HTTP plane on an ephemeral port with no
daemon tree.  The port's own cases: ``/doctor`` and ``/timeline`` with
no tenant (the idle documents) and the index page, and the three live
tools' ``--uri`` modes against the endpoint.
"""

from __future__ import annotations

import json
import time
import urllib.request

import pytest

import tests.runtime.test_obs_plane as ref_obs
from tests.torch_mirror import mirror


@pytest.fixture
def scrape_hnp(tmp_path):
    from ompi_tpu_torch.runtime.dvm import DvmHnp

    hnp = DvmHnp(uri_path=str(tmp_path / "dvm.uri"))
    hnp._start_metrics_server(0)     # ephemeral port
    try:
        yield hnp
    finally:
        if hnp._http is not None:
            hnp._http.shutdown()
            hnp._http.server_close()   # release the listening socket


@pytest.mark.parametrize("name", [
    "test_scrape_metrics_known_counter_under_job_label",
    "test_scrape_status_ft_timeline_and_metrics_age",
    "test_scrape_unknown_path_404",
    "test_scrape_metrics_no_duplicate_type_lines",
    "test_ps_proc_rows_gain_lives_and_metrics_age",
    "test_scrape_status_straggler_panel_names_slowest_rank",
    "test_scrape_metrics_histogram_series_round_trip",
    "test_ps_proc_rows_gain_coll_p99_column",
    "test_ps_proc_rows_gain_rejoins_column"])
def test_scrape_case_on_the_port(name, scrape_hnp):
    mirror(getattr(ref_obs, name), True, [])(scrape_hnp)


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def test_idle_doctor_timeline_and_index(scrape_hnp):
    base = scrape_hnp.metrics_uri
    doc = json.loads(_get(base + "/doctor"))
    assert doc["verdict"]["kind"] == "idle"
    tl = json.loads(_get(base + "/timeline?tail=16"))
    assert tl["traceEvents"] == [] and tl["otherData"]["idle"] is True
    assert _get(base + "/") == \
        "ompi_tpu dvm: /metrics /status /doctor /timeline\n"


def test_live_tools_read_the_endpoint(scrape_hnp, tmp_path, capsys):
    """``hang_doctor --uri`` (through the uri file's ``.metrics``
    sidecar), ``timeline --uri`` and ``straggler_report --uri`` read the
    pool's documents."""
    from ompi_tpu_torch.tools import hang_doctor, straggler_report, timeline

    jobid = 616
    rows = {}
    for rank, wait_ns in ((0, 9_000_000_000), (1, 400_000_000)):
        rows[rank] = [time.time(), {"coll_arena_wait_ns": ref_obs._vec(
            "a", (20, 5), total=wait_ns)}]
    scrape_hnp.metrics_agg.merge({jobid: rows})
    assert hang_doctor.main(["--uri", scrape_hnp.uri_path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["verdict"]["kind"] == "idle"
    assert hang_doctor.main(["--uri", scrape_hnp.uri_path, "--expect",
                             "mismatch"]) == 1
    capsys.readouterr()
    assert straggler_report.main(["--uri", scrape_hnp.metrics_uri]) == 0
    out = capsys.readouterr().out
    assert f"job {jobid}" in out and "slowest rank: 1" in out
    # an idle pool has no capture to plot: exit 3, no file written
    path = tmp_path / "tl.json"
    assert timeline.main(["--uri", scrape_hnp.metrics_uri,
                          "-o", str(path)]) == 3
    assert not path.exists()
