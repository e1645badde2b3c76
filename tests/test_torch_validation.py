"""The paper's validation layer on the port's copies (repro_torch.pils,
repro_torch.appsim, repro_torch.core.scalability and .traceview): every
paper value that tests/test_pils_usecases.py (§5.1, Figs. 4–10),
tests/test_appsim.py (§5.2, Tables 1–3) and
tests/test_scalability_traceview.py assert on ``repro`` holds here on
``repro_torch``, with the same tolerances. No JAX is imported."""

import pytest

pytest.importorskip("torch")

from repro_torch.appsim import node_scan  # noqa: E402
from repro_torch.core.analysis import analyze_trace  # noqa: E402
from repro_torch.core.backends import SyntheticTraceBuilder  # noqa: E402
from repro_torch.core.scalability import (  # noqa: E402
    render_scalability,
    scalability_scan,
)
from repro_torch.core.traceview import render_trace  # noqa: E402
from repro_torch.pils import USE_CASES, run_use_case, use_case  # noqa: E402

approx = pytest.approx


# ---------------------------------------------------------------------------
# §5.1 — the seven PILS use cases
# ---------------------------------------------------------------------------
def _uc1(r):
    """All metrics 100% except Device Offload Eff. (low) and
    Orchestration Eff. (82%)."""
    h, d = r.analyses["trace"].host, r.analyses["trace"].device
    assert h.mpi_parallel_efficiency == approx(1.0, abs=1e-6)
    assert h.communication_efficiency == approx(1.0, abs=1e-6)
    assert h.load_balance == approx(1.0, abs=1e-6)
    assert d.load_balance == approx(1.0, abs=1e-6)
    assert d.communication_efficiency == approx(1.0, abs=1e-6)
    assert d.orchestration_efficiency == approx(0.82, abs=0.005)
    assert h.device_offload_efficiency < 0.25


def _uc2(r):
    """Host metrics ~100%, Device Offload Eff. 94%, Device PE 5%."""
    h, d = r.analyses["trace"].host, r.analyses["trace"].device
    assert h.device_offload_efficiency == approx(0.94, abs=0.005)
    assert h.mpi_parallel_efficiency == approx(1.0, abs=1e-6)
    assert d.parallel_efficiency == approx(0.05, abs=0.005)


def _uc3(r):
    """Device LB 55%, Device Offload Eff. 26%; balanced useful time, yet
    host LB degraded by the offload imbalance."""
    a = r.analyses["trace"]
    h, d = a.host, a.device
    assert d.load_balance == approx(0.55, abs=0.005)
    assert h.device_offload_efficiency == approx(0.26, abs=0.005)
    assert a.host_states[0]["useful"] == approx(a.host_states[1]["useful"],
                                                rel=1e-6)
    assert h.load_balance < 0.7
    assert h.mpi_parallel_efficiency < 0.7


def _uc4(r):
    """Host LB 55%, device LB 55%, low Orchestration Eff."""
    h, d = r.analyses["trace"].host, r.analyses["trace"].device
    assert h.load_balance == approx(0.55, abs=0.005)
    assert d.load_balance == approx(0.55, abs=0.005)
    assert d.orchestration_efficiency == approx(0.20, abs=0.01)
    assert h.device_offload_efficiency < 0.9


def _uc5(r):
    """Host LB 70%, Orchestration Eff. 33%, low host and device PE, the
    same global load on CPU and GPU (within 15%)."""
    a = r.analyses["trace"]
    h, d = a.host, a.device
    assert h.load_balance == approx(0.70, abs=0.005)
    assert d.orchestration_efficiency == approx(0.33, abs=0.005)
    assert h.parallel_efficiency < 0.75
    assert d.parallel_efficiency < 0.4
    cpu = sum(s["useful"] for s in a.host_states.values())
    gpu = sum(s["kernel"] for s in a.device_states.values())
    assert cpu == approx(gpu, rel=0.15)


def _uc6(r):
    """Device Comm. Eff. 36%, Orchestration 86%, host LB 72%, very low
    Device Offload Eff.; the transfer is memory state on device 0 only."""
    a = r.analyses["trace"]
    h, d = a.host, a.device
    assert d.communication_efficiency == approx(0.36, abs=0.005)
    assert d.orchestration_efficiency == approx(0.86, abs=0.005)
    assert h.load_balance == approx(0.72, abs=0.01)
    assert h.device_offload_efficiency < 0.25
    assert a.device_states[0]["memory"] > 0
    assert a.device_states[1]["memory"] == approx(0.0, abs=1e-9)


def _uc7(r):
    """Only Device Offload Eff. and Orchestration Eff. differ between the
    runs: offload 67% -> ~100%, orchestration 33% -> ~50%."""
    no, ov = r.analyses["no_overlap"], r.analyses["overlap"]
    assert no.host.load_balance == approx(ov.host.load_balance, abs=1e-6)
    assert no.host.communication_efficiency == approx(
        ov.host.communication_efficiency, abs=1e-6)
    assert no.device.load_balance == approx(ov.device.load_balance, abs=1e-6)
    assert no.device.communication_efficiency == approx(
        ov.device.communication_efficiency, abs=1e-6)
    assert no.host.device_offload_efficiency == approx(2 / 3, abs=0.005)
    assert ov.host.device_offload_efficiency == approx(1.0, abs=0.005)
    assert no.device.orchestration_efficiency == approx(1 / 3, abs=0.005)
    assert ov.device.orchestration_efficiency == approx(0.5, abs=0.005)


PAPER_VALUES = {"uc1": _uc1, "uc2": _uc2, "uc3": _uc3, "uc4": _uc4,
                "uc5": _uc5, "uc6": _uc6, "uc7": _uc7}


@pytest.mark.parametrize("name", sorted(PAPER_VALUES))
def test_pils_use_case_reproduces_paper_values(name):
    """Figs. 4–10: each use case's stated metric values, every trace of it
    validating its multiplicative hierarchy and trees."""
    r = run_use_case(name)
    assert r.name == name and r.description == USE_CASES[name][1]
    PAPER_VALUES[name](r)
    for a in r.analyses.values():
        a.validate(tol=1e-6)
        for tree in a.trees().values():
            tree.validate(tol=1e-6)


# ---------------------------------------------------------------------------
# §5.2 — the three application emulators (Tables 1–3)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scans():
    return {app: node_scan(app) for app in ("sod2d", "fall3d", "xshells")}


def _sod2d(s):
    """Table 1: n=1 column (MPI PE .94, CE .95, LB 1.0, DOE .06, dev PE
    .87); at 8 nodes CE and Orchestration degrade, DOE flat, LB high,
    both degrading monotonically."""
    a1, a8 = s[1], s[8]
    assert a1.host.mpi_parallel_efficiency == approx(0.94, abs=0.02)
    assert a1.host.communication_efficiency == approx(0.95, abs=0.02)
    assert a1.host.load_balance == approx(1.0, abs=0.02)
    assert a1.host.device_offload_efficiency == approx(0.06, abs=0.01)
    assert a1.device.parallel_efficiency == approx(0.87, abs=0.03)
    assert a8.host.communication_efficiency == approx(0.68, abs=0.04)
    assert a8.device.orchestration_efficiency == approx(0.60, abs=0.06)
    assert a8.host.device_offload_efficiency == approx(0.06, abs=0.01)
    assert a8.device.load_balance > 0.95
    ce = [s[n].host.communication_efficiency for n in (1, 2, 4, 8)]
    oe = [s[n].device.orchestration_efficiency for n in (1, 2, 4, 8)]
    assert ce == sorted(ce, reverse=True)
    assert oe == sorted(oe, reverse=True)


def _fall3d(s):
    """Table 2: n=1 (LB .52, DOE .59, dev CE .78, Orch .19); LB collapses
    to ~.12 and Orchestration to ~.04 at 8 nodes; device LB stays high."""
    a1, a8 = s[1], s[8]
    assert a1.host.load_balance == approx(0.52, abs=0.04)
    assert a1.host.device_offload_efficiency == approx(0.59, abs=0.05)
    assert a1.device.communication_efficiency == approx(0.78, abs=0.02)
    assert a1.device.orchestration_efficiency == approx(0.19, abs=0.04)
    assert a8.host.load_balance == approx(0.12, abs=0.04)
    assert a8.device.orchestration_efficiency == approx(0.04, abs=0.02)
    for n in (1, 2, 4, 8):
        assert s[n].device.load_balance > 0.95


def _xshells(s):
    """Table 3: n=1 (DOE .40, dev CE .98, LB 1.0, Orch .54); host CE drops
    hard, DOE rises, Orchestration falls; LB stays ~1.0."""
    a1, a8 = s[1], s[8]
    assert a1.host.device_offload_efficiency == approx(0.40, abs=0.03)
    assert a1.device.communication_efficiency == approx(0.98, abs=0.01)
    assert a1.device.load_balance == approx(1.0, abs=0.01)
    assert a1.device.orchestration_efficiency == approx(0.54, abs=0.05)
    assert a8.host.communication_efficiency < 0.65
    assert a8.host.device_offload_efficiency > a1.host.device_offload_efficiency
    assert a8.device.orchestration_efficiency < 0.35
    for n in (1, 2, 4, 8):
        assert s[n].host.load_balance > 0.93


TABLES = {"sod2d": _sod2d, "fall3d": _fall3d, "xshells": _xshells}


@pytest.mark.parametrize("app", sorted(TABLES))
def test_appsim_node_scan_reproduces_paper_table(scans, app):
    TABLES[app](scans[app])
    for a in scans[app].values():
        a.validate(tol=1e-6)


# ---------------------------------------------------------------------------
# POP scalability across runs, and the trace renderer
# ---------------------------------------------------------------------------
def _run(nranks, work, mpi):
    b = SyntheticTraceBuilder(nranks=nranks, ndevices=nranks)
    for r in range(nranks):
        b.rank(r).useful(work).offload_kernel(work * 2)
        if mpi:
            b.rank(r).mpi(mpi)
    return analyze_trace(b.build())


def test_perfect_strong_scaling():
    """Halving work per rank when doubling ranks gives GE = 1."""
    runs = [_run(2, 1.0, 0.0), _run(4, 0.5, 0.0), _run(8, 0.25, 0.0)]
    pts = scalability_scan(runs, labels=["2", "4", "8"])
    for p in pts:
        p.validate()
        assert p.global_efficiency == approx(1.0, abs=1e-6)
    assert pts[2].speedup == approx(4.0, abs=1e-6)


def test_degraded_scaling_shows_in_global_eff():
    runs = [_run(2, 1.0, 0.0), _run(4, 0.5, 0.2), _run(8, 0.25, 0.3)]
    pts = scalability_scan(runs, labels=["2", "4", "8"])
    ges = [p.global_efficiency for p in pts]
    assert ges[0] == approx(1.0)
    assert ges[1] < 1.0 and ges[2] < ges[1]
    for p in pts:
        p.validate()
    text = render_scalability(pts)
    assert "GlobalEff" in text and "8" in text


def test_scalability_on_appsim_scan(scans):
    """XSHELLS node scan: global efficiency decays monotonically."""
    scan = scans["xshells"]
    pts = scalability_scan([scan[n] for n in (1, 2, 4, 8)],
                           labels=["1", "2", "4", "8"],
                           resources=[4, 8, 16, 32])
    ges = [p.global_efficiency for p in pts]
    assert all(ges[i] >= ges[i + 1] - 1e-9 for i in range(len(ges) - 1))
    for p in pts:
        p.validate(tol=1e-6)


def test_render_trace_pils():
    """Use case 6: kernels on both devices, the transfer on device 0 only,
    rank 1 waiting in MPI."""
    lines = render_trace(use_case("uc6")["trace"], width=60).splitlines()
    assert len(lines) == 1 + 2 + 2
    dev0 = next(ln for ln in lines if ln.startswith("dev    0"))
    dev1 = next(ln for ln in lines if ln.startswith("dev    1"))
    assert "=" in dev0 and "=" not in dev1
    assert "#" in dev0 and "#" in dev1
    rank1 = next(ln for ln in lines if ln.startswith("rank   1"))
    assert "m" in rank1


def test_render_trace_idle_classification():
    b = SyntheticTraceBuilder(nranks=1, ndevices=1)
    b.rank(0).useful(1.0).offload_kernel(1.0).useful(2.0)
    dev = next(ln for ln in render_trace(b.build(), width=40).splitlines()
               if ln.startswith("dev"))
    assert "." in dev and "#" in dev


def test_render_trace_zero_width_window():
    b = SyntheticTraceBuilder(nranks=1, ndevices=1)
    b.rank(0).useful(1.0).offload_kernel(1.0)
    tr = b.build()
    tr.window = (2.0, 2.0)
    lines = render_trace(tr, width=40).splitlines()
    assert len(lines) == 3
    assert set(lines[1].split("|")[1]) <= {" "}
    assert set(lines[2].split("|")[1]) <= {"."}


def test_render_trace_legend_flag():
    b = SyntheticTraceBuilder(nranks=1, ndevices=1)
    b.rank(0).useful(1.0)
    tr = b.build()
    assert "#=useful" in render_trace(tr).splitlines()[0]
    assert "#=useful" not in render_trace(tr, legend=False).splitlines()[0]
