"""Multi-rank aggregation: merge per-rank TALP results into job-level ones.

The paper computes its host/device efficiency hierarchies (eqs. 6–12)
*across all ranks and devices of a job*. :class:`~repro.core.talp.TalpMonitor`
measures one process; this module is the central-aggregation step that
turns N per-rank :class:`TalpResult` payloads into the job-level report
TALP prints (per-rank collection + cheap central merge — the architecture
production job-monitoring systems use to scale).

Merge semantics:

  * **region-name union** — a region appears in the job report if any rank
    measured it; ranks that never entered it contribute nothing to that
    region's metrics (``n_ranks`` is per-region).
  * **host states** — kept per rank, keyed by the monitor's rank id; rank
    ids must be unique across the merged results.
  * **devices** — each rank's devices are distinct physical accelerators,
    so local device ids are remapped to dense job-global ids in
    (result-order, local-id) order. The remap is deterministic, which
    makes the merge associative: ``merge(merge(a, b), c) == merge(a, b, c)``.
  * **elapsed** — paper eq. (1): the job window is the max over ranks.
  * **metrics** — recomputed from the merged state durations (never
    averaged from per-rank metrics), so ``validate()`` multiplicativity
    holds exactly on the merged result.

Three transports move the per-rank payloads to the merge point:

  * :class:`InProcessGather` — ranks in one process (tests, simulated
    multi-rank runs, threads).
  * :class:`FileSpoolTransport` — each rank spools its payload to a
    shared directory: the versioned binary format by default
    (``talp_rank*.npz``: JSON header + NPZ timeline columns) or the
    legacy ``report.to_json`` text (``talp_rank*.json``); the merge side
    auto-detects either. Any process can merge the spool post mortem —
    TALP's "machine-readable output enabling automated processing" path,
    across nodes on a shared FS.
  * :class:`AllGatherTransport` — a ``torch.distributed`` collective:
    with an initialised process group of several ranks the JSON payloads
    are exchanged via ``all_gather_object`` so every rank obtains the job
    result; on a single process it degenerates to a local merge.

Copied from ``repro.core.merge``; the one change is
:class:`AllGatherTransport`, which the JAX package builds on
``jax.distributed``.

Post-mortem CLI: ``python -m repro_torch.core.merge <spool_dir>`` (add
``--trace-out job.trace.json`` for a job-level Chrome/Perfetto trace
built from the merged result and any raw timeline attachments).
"""

from __future__ import annotations

import io
import itertools
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .collect import (
    FaultPlan,
    QuarantinedSpool,
    RankCoverage,
    SpoolPayloadError,
    SpoolVersionError,
    quarantine_spool,
    read_spool_payload,
    wait_for_ranks,
)
from .device_metrics import DeviceMetrics
from .hierarchy import DEVICE, HOST, StateDurations
from .host_metrics import HostMetrics
from .states import DeviceTimeline
from .talp import RegionResult, TalpResult
from .telemetry import overhead as _ovh

__all__ = [
    "merge_region_results",
    "merge_results",
    "merge_samples",
    "merge_step_series",
    "region_result_from_dict",
    "talp_result_from_json",
    "result_to_spool_bytes",
    "result_from_spool_bytes",
    "result_to_spool_json",
    "result_from_spool_json",
    "load_spool_payload",
    "InProcessGather",
    "FileSpoolTransport",
    "AllGatherTransport",
    "merge_spool",
    "emit_job_report",
    "RankCoverage",
    "QuarantinedSpool",
    "FaultPlan",
]

#: Per-process monotonic counter for unique temp names: concurrent
#: writers (threads, or two processes that were handed the same rank id)
#: must never share a temp file, or one can publish the other's
#: half-written bytes via ``os.replace``.
_TMP_SEQ = itertools.count()


def _tmp_name(path: str) -> str:
    return f"{path}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"


def _fsync_write(path: str, data, mode: str) -> None:
    """Write + flush + fsync a temp file, then atomically publish it.
    Readers either see the old complete file or the new complete file —
    never a partial one, even across a crash mid-write."""
    tmp = _tmp_name(path)
    try:
        with open(tmp, mode) as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise

#: Version stamp of the binary spool payload (NPZ columns + JSON header).
SPOOL_BINARY_VERSION = 1


# ---------------------------------------------------------------------------
# core merge — metrics recomputed through the hierarchy engine
# ---------------------------------------------------------------------------
def _recompute_host(
    host_states: Dict[int, Dict[str, float]], elapsed: float,
    extras: Optional[Dict[str, float]] = None,
) -> Optional[HostMetrics]:
    if not host_states or elapsed <= 0:
        return None
    sd = StateDurations.from_states(
        host_states=host_states, elapsed=elapsed, extras=extras
    )
    return HostMetrics.from_frame(HOST.compute(sd))


def _recompute_device(
    device_states: Dict[int, Dict[str, float]], elapsed: float,
    extras: Optional[Dict[str, float]] = None,
) -> Optional[DeviceMetrics]:
    if not device_states or elapsed <= 0:
        return None
    sd = StateDurations.from_states(
        device_states=device_states, elapsed=elapsed, extras=extras
    )
    return DeviceMetrics.from_frame(DEVICE.compute(sd))


def merge_region_results(
    parts: Sequence[RegionResult], name: Optional[str] = None
) -> RegionResult:
    """Merge the same region measured by N ranks into one job-level result."""
    parts = list(parts)
    if not parts:
        raise ValueError("merge_region_results: empty input")
    name = name or parts[0].name
    elapsed = max(p.elapsed for p in parts)

    host_states: Dict[int, Dict[str, float]] = {}
    for p in parts:
        for rank, st in p.host_states.items():
            if rank in host_states:
                raise ValueError(
                    f"duplicate rank {rank} while merging region {name!r}; "
                    "give each monitor a distinct rank id"
                )
            host_states[rank] = dict(st)

    # Device-id remap: dense job-global ids in (part-order, local-id) order.
    # Idle is re-anchored to the job window (E may grow under the merge).
    device_states: Dict[int, Dict[str, float]] = {}
    gid = 0
    for p in parts:
        for dev in sorted(p.device_states):
            st = p.device_states[dev]
            k, m = st["kernel"], st["memory"]
            device_states[gid] = {
                "kernel": k,
                "memory": m,
                "idle": max(0.0, elapsed - k - m),
            }
            gid += 1

    # Self-overhead annotation: a wall-clock fraction does not compose
    # additively across ranks; the conservative job-level statement is
    # the worst rank's fraction (max-carry — absent unless some rank
    # measured it).
    overheads = [
        ov for ov in (getattr(p.host, "talp_overhead", None) for p in parts)
        if ov is not None
    ]
    extras = {"talp_overhead": max(overheads)} if overheads else None

    # Measured Computational Efficiency (FLOPs over peak·busy) composes
    # as the kernel-busy-weighted mean across ranks: Σ flops_i / (peak ·
    # Σ busy_i) with flops_i = CE_i · peak · busy_i. Busy per rank is the
    # sum of its device kernel durations, which the reduced states carry.
    ce_num = ce_den = 0.0
    for p in parts:
        ce = getattr(p.device, "computational_efficiency", None)
        if ce is None:
            continue
        busy = sum(st["kernel"] for st in p.device_states.values())
        ce_num += ce * busy
        ce_den += busy
    dev_extras = (
        {"computational_efficiency": ce_num / ce_den} if ce_den > 0 else None
    )

    return RegionResult(
        name=name,
        elapsed=elapsed,
        n_ranks=len(host_states),
        n_devices=len(device_states),
        host=_recompute_host(host_states, elapsed, extras=extras),
        device=_recompute_device(device_states, elapsed, extras=dev_extras),
        host_states=host_states,
        device_states=device_states,
    )


def merge_results(
    results: Sequence[TalpResult],
    name: Optional[str] = None,
    coverage: Optional[RankCoverage] = None,
) -> TalpResult:
    """Merge N per-rank :class:`TalpResult` payloads into the job result.

    ``coverage`` (a :class:`~repro.core.collect.RankCoverage`) annotates a
    *partial* merge — which ranks were expected, merged, missing or
    quarantined. It rides on the returned result's ``rank_coverage`` and
    is carried through the report JSON round trip, the text report, the
    telemetry exporter and the Chrome trace metadata; the merged metrics
    themselves are computed from exactly the results given, identically
    to a clean merge of those ranks.
    """
    results = list(results)
    if not results:
        raise ValueError("merge_results: empty input")
    region_names: List[str] = []
    for r in results:
        for rn in r.regions:
            if rn not in region_names:
                region_names.append(rn)
    merged = {
        rn: merge_region_results(
            [r.regions[rn] for r in results if rn in r.regions], name=rn
        )
        for rn in region_names
    }
    return TalpResult(
        name=name or results[0].name, regions=merged, rank_coverage=coverage
    )


def merge_samples(
    results: Sequence[TalpResult], name: Optional[str] = None
) -> TalpResult:
    """Merge mid-run snapshots (``TalpMonitor.sample_result()``) across
    ranks into a job-level snapshot — TALP's online mode at job scope.

    The algebra is identical to :func:`merge_results`: the snapshot
    window is the max elapsed over ranks, so ranks caught at different
    progress still merge into one internally consistent report
    (``validate()`` holds). On finalized runs the result agrees exactly
    with a post-mortem :func:`merge_results`.
    """
    return merge_results(results, name=name)


def merge_step_series(series_by_rank: Dict[int, "object"], name: str = "job"):
    """Rank-align per-rank step series into one job-level per-step table.

    Rows are aligned by ``(region name, step index)`` — step *k* of
    region *r* on every rank is the same logical step of the program, so
    the job-level row for it is computed across exactly those ranks.

    Host metrics are **recomputed** through the hierarchy engine (the
    merge-layer invariant: never average per-rank efficiencies): each
    step row carries its per-window ``useful``/``offload``/``mpi``
    durations, which stacked across ranks are precisely the
    :class:`~repro.core.hierarchy.StateDurations` HOST needs — so
    job-level per-step ``load_balance`` etc. are exact, including any
    ``with_child()`` host metric whose formula reads those inputs.
    Device-hierarchy columns (and any column the engine cannot rebuild
    from the carried inputs) are summarized as the across-rank mean —
    the per-device vectors behind them are not carried per step.

    Returns a :class:`~repro.core.telemetry.stepseries.StepSeries`
    holding the merged table; its base ``useful``/``offload``/``mpi``
    are across-rank sums and a trailing ``n_ranks`` column records
    coverage per row.
    """
    from .telemetry.stepseries import BASE_FIELDS, StepSeries

    if not series_by_rank:
        raise ValueError("merge_step_series: empty input")
    rank_rows: Dict[int, Dict[Tuple[str, int], np.void]] = {}
    metric_cols: List[str] = []
    for rank in sorted(series_by_rank):
        s = series_by_rank[rank]
        rows = s.rows()
        for c in s.metric_columns:
            if c not in metric_cols:
                metric_cols.append(c)
        by_key = rank_rows.setdefault(rank, {})
        for row in rows:
            by_key[(s.region_name(row["region"]), int(row["step"]))] = row
    keys = sorted(
        {k for by_key in rank_rows.values() for k in by_key},
        key=lambda k: (min(
            float(by_key[k]["t_open"])
            for by_key in rank_rows.values() if k in by_key
        ), k[0], k[1]),
    )
    out = StepSeries.from_arrays(
        rows=np.zeros(
            len(keys),
            dtype=np.dtype(
                list(BASE_FIELDS)
                + [(c, "f8") for c in metric_cols]
                + [("n_ranks", "f8")]
            ),
        ),
        regions=np.asarray([], dtype=np.str_),
        n_total=len(keys),
    )
    for i, (region, step) in enumerate(keys):
        parts = [
            by_key[(region, step)]
            for by_key in rank_rows.values()
            if (region, step) in by_key
        ]
        row = out._buf[i]
        rid = out._region_ids.get(region)
        if rid is None:
            rid = len(out._region_names)
            out._region_ids[region] = rid
            out._region_names.append(region)
        row["region"] = rid
        row["step"] = step
        row["t_open"] = min(float(p["t_open"]) for p in parts)
        row["t_close"] = max(float(p["t_close"]) for p in parts)
        elapsed = max(float(p["elapsed"]) for p in parts)
        row["elapsed"] = elapsed
        for f in ("useful", "offload", "mpi"):
            row[f] = sum(float(p[f]) for p in parts)
        row["n_ranks"] = len(parts)
        hvals: Dict[str, float] = {}
        if elapsed > 0:
            sd = StateDurations(
                elapsed=elapsed,
                useful=[float(p["useful"]) for p in parts],
                offload=[float(p["offload"]) for p in parts],
                mpi=[float(p["mpi"]) for p in parts],
            )
            hvals = HOST.compute(sd).values
        for c in metric_cols:
            hname, _, key = c.partition("_")
            if hname == "host" and key in hvals:
                row[c] = hvals[key]
                continue
            vals = [
                float(p[c]) for p in parts
                if c in (p.dtype.names or ()) and not np.isnan(p[c])
            ]
            row[c] = float(np.mean(vals)) if vals else np.nan
    # the table's identity, for CLI display
    out.name = name  # type: ignore[attr-defined]
    return out


# ---------------------------------------------------------------------------
# JSON reconstruction (the inverse of report.to_json, metrics recomputed)
# ---------------------------------------------------------------------------
def region_result_from_dict(d: Dict, name: Optional[str] = None) -> RegionResult:
    """Rebuild a :class:`RegionResult` from its ``report.to_json`` dict.

    Metrics are *recomputed* from the serialized state durations rather
    than trusted from the payload, so a merged result is always internally
    consistent (and ``validate()`` holds) even across producer versions.
    """
    name = name or d.get("name", "Global")
    elapsed = float(d["elapsed"])
    host_states = {
        int(r): {k: float(v) for k, v in st.items()}
        for r, st in (d.get("host_states") or {}).items()
    }
    device_states = {
        int(dev): {k: float(v) for k, v in st.items()}
        for dev, st in (d.get("device_states") or {}).items()
    }
    # talp_overhead and computational_efficiency are measurements (the
    # producer's self-cost / FLOP-model feed), not derivable from the
    # reduced states — they are the values trusted from the payload
    # rather than recomputed.
    ov = (d.get("host_metrics") or {}).get("talp_overhead")
    extras = {"talp_overhead": float(ov)} if ov is not None else None
    ce = (d.get("device_metrics") or {}).get("computational_efficiency")
    dev_extras = {"computational_efficiency": float(ce)} if ce is not None else None
    return RegionResult(
        name=name,
        elapsed=elapsed,
        n_ranks=len(host_states),
        n_devices=len(device_states),
        host=_recompute_host(host_states, elapsed, extras=extras),
        device=_recompute_device(device_states, elapsed, extras=dev_extras),
        host_states=host_states,
        device_states=device_states,
    )


def talp_result_from_json(text: str) -> TalpResult:
    """Rebuild a :class:`TalpResult` from ``report.to_json`` output."""
    payload = json.loads(text)
    if "regions" not in payload:
        # single-region payload: wrap it
        rr = region_result_from_dict(payload)
        return TalpResult(name=rr.name, regions={rr.name: rr})
    cov = payload.get("rank_coverage")
    return TalpResult(
        name=payload.get("talp", "talp"),
        regions={
            rn: region_result_from_dict(rd, name=rn)
            for rn, rd in payload["regions"].items()
        },
        rank_coverage=RankCoverage.from_dict(cov) if cov is not None else None,
    )


# ---------------------------------------------------------------------------
# spool payloads — versioned binary (NPZ columns) + JSON (legacy/reference)
# ---------------------------------------------------------------------------
def _timelines_header(
    timelines: Optional[Dict[int, DeviceTimeline]]
) -> Tuple[Dict[str, Dict], Dict[str, np.ndarray]]:
    """Split attached timelines into (per-device meta, named column arrays)."""
    meta: Dict[str, Dict] = {}
    arrays: Dict[str, np.ndarray] = {}
    for dev, tl in sorted((timelines or {}).items()):
        cols = tl.to_columns()
        meta[str(dev)] = cols["meta"]
        arrays[f"dev{dev}_pending"] = cols["pending"]
        arrays[f"dev{dev}_kernel"] = cols["kernel"]
        arrays[f"dev{dev}_memory"] = cols["memory"]
    return meta, arrays


def result_to_spool_bytes(
    result: TalpResult,
    timelines: Optional[Dict[int, DeviceTimeline]] = None,
) -> bytes:
    """Encode one rank's payload in the **binary spool format**: an NPZ
    container whose ``header`` entry is the UTF-8 JSON report (host
    states, region metadata — exactly the ``report.to_json`` dict, plus a
    version stamp) and whose remaining entries are the columnar device
    timelines (structured pending rows + flattened per-kind interval
    arrays). A million-record rank serializes with four array writes per
    device — no per-record encoding anywhere.
    """
    from .report import to_json

    tl_meta, arrays = _timelines_header(timelines)
    header = {
        "version": SPOOL_BINARY_VERSION,
        "format": "talp-spool",
        "result": json.loads(to_json(result)),
        "timelines": tl_meta,
    }
    buf = io.BytesIO()
    np.savez(
        buf,
        header=np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8),
        **arrays,
    )
    return buf.getvalue()


def result_from_spool_bytes(
    data: bytes,
) -> Tuple[TalpResult, Dict[int, DeviceTimeline]]:
    """Decode :func:`result_to_spool_bytes` (metrics recomputed, exact
    timeline state reconstruction)."""
    with np.load(io.BytesIO(data), allow_pickle=False) as npz:
        header = json.loads(bytes(npz["header"]).decode("utf-8"))
        version = header.get("version")
        if version is None or version > SPOOL_BINARY_VERSION:
            raise SpoolVersionError(
                f"binary spool payload version {version!r} "
                f"(this reader supports <= {SPOOL_BINARY_VERSION})"
            )
        result = talp_result_from_json(json.dumps(header["result"]))
        timelines: Dict[int, DeviceTimeline] = {}
        for dev_s, meta in header.get("timelines", {}).items():
            dev = int(dev_s)
            timelines[dev] = DeviceTimeline.from_columns(
                pending=npz[f"dev{dev}_pending"],
                kernel=npz[f"dev{dev}_kernel"],
                memory=npz[f"dev{dev}_memory"],
                device=meta.get("device", dev),
                compact_threshold=meta.get("compact_threshold", 65536),
                n_compacted=meta.get("n_compacted", 0),
                span=meta.get("span"),
                n_kernel=meta.get("n_kernel"),
            )
    return result, timelines


def _timeline_to_json_obj(tl: DeviceTimeline) -> Dict:
    """Per-record JSON encoding of a timeline — the retained object-path
    reference the binary format is benchmarked against (and the shape the
    legacy JSON spool uses when timelines are attached)."""
    cols = tl.to_columns()
    pending = cols["pending"]
    return {
        **cols["meta"],
        "records": [
            [int(k), float(s), float(e), int(st)]
            for k, s, e, st in zip(
                pending["kind"], pending["start"],
                pending["end"], pending["stream"],
            )
        ],
        "kernel": cols["kernel"].tolist(),
        "memory": cols["memory"].tolist(),
    }


def _timeline_from_json_obj(d: Dict) -> DeviceTimeline:
    recs = np.asarray(d.get("records") or np.zeros((0, 4)), dtype=np.float64)
    recs = recs.reshape(-1, 4)
    from .recordio import RECORD_DTYPE

    pending = np.empty(len(recs), dtype=RECORD_DTYPE)
    pending["kind"] = recs[:, 0].astype(np.uint8)
    pending["start"] = recs[:, 1]
    pending["end"] = recs[:, 2]
    pending["stream"] = recs[:, 3].astype(np.uint32)
    return DeviceTimeline.from_columns(
        pending=pending,
        kernel=np.asarray(d.get("kernel") or np.zeros((0, 2))).reshape(-1, 2),
        memory=np.asarray(d.get("memory") or np.zeros((0, 2))).reshape(-1, 2),
        device=d.get("device", 0),
        compact_threshold=d.get("compact_threshold", 65536),
        n_compacted=d.get("n_compacted", 0),
        span=d.get("span"),
        n_kernel=d.get("n_kernel"),
    )


def result_to_spool_json(
    result: TalpResult,
    timelines: Optional[Dict[int, DeviceTimeline]] = None,
) -> str:
    """Legacy JSON spool payload (``report.to_json`` text); attached
    timelines are encoded per record under ``device_timelines``."""
    from .report import to_json

    if not timelines:
        return to_json(result)
    payload = json.loads(to_json(result))
    payload["device_timelines"] = {
        str(dev): _timeline_to_json_obj(tl)
        for dev, tl in sorted(timelines.items())
    }
    return json.dumps(payload, indent=2)


def result_from_spool_json(
    text: str,
) -> Tuple[TalpResult, Dict[int, DeviceTimeline]]:
    result = talp_result_from_json(text)
    payload = json.loads(text)
    timelines = {
        int(dev): _timeline_from_json_obj(d)
        for dev, d in (payload.get("device_timelines") or {}).items()
    }
    return result, timelines


def load_spool_payload(path: str) -> Tuple[TalpResult, Dict[int, DeviceTimeline]]:
    """Read one spool file, auto-detecting the payload format: ``.npz``
    files hold the versioned binary payload, anything else is parsed as
    (legacy) JSON. Returns ``(result, timelines)``; ``timelines`` is
    empty when the payload carries none."""
    if path.endswith(".npz"):
        with open(path, "rb") as f:
            return result_from_spool_bytes(f.read())
    with open(path) as f:
        return result_from_spool_json(f.read())


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
class InProcessGather:
    """Collect per-rank results in one process and merge on demand."""

    def __init__(self, world_size: Optional[int] = None):
        self.world_size = world_size
        self._results: Dict[int, TalpResult] = {}

    def submit(self, result: TalpResult, rank: int) -> None:
        if rank in self._results:
            raise ValueError(f"rank {rank} already submitted")
        self._results[rank] = result

    def ready(self) -> bool:
        if self.world_size is None:
            return bool(self._results)
        return len(self._results) >= self.world_size

    def merge(self, name: Optional[str] = None) -> TalpResult:
        if not self._results:
            raise ValueError("no results submitted")
        return merge_results(
            [self._results[r] for r in sorted(self._results)], name=name
        )


class FileSpoolTransport:
    """Per-rank spool on a shared filesystem.

    Each rank writes ``talp_rank<rank>.npz`` (versioned binary payload:
    JSON header + NPZ timeline columns, see
    :func:`result_to_spool_bytes`) or — with ``payload="json"`` —
    ``talp_rank<rank>.json`` (the legacy ``report.to_json`` text). The
    merge side lists the spool, auto-detects each file's format,
    reconstructs every per-rank result and merges; spools written by
    older (JSON-only) producers merge unchanged. Post-mortem by design:
    the spool is the job's machine-readable artifact and can be
    re-merged at any time.

    ``submit(..., timelines=...)`` optionally attaches raw per-device
    :class:`DeviceTimeline` state (columnar in the binary format,
    per-record JSON in the legacy one) so post-mortem tooling can
    re-window or re-render the activity, not just read the reduced
    states; :meth:`collect_timelines` reads them back.

    Use a fresh directory per job: leftover rank files from a previous
    run in the same directory would merge into the new report. Files
    whose rank id is outside ``[0, world_size)`` are rejected as stale;
    same-shape leftovers are indistinguishable from live ranks and are
    the caller's responsibility.
    """

    PREFIX = "talp_rank"
    SAMPLE_PREFIX = "talp_sample_rank"
    #: step-series spools are always NPZ (structured-array payload)
    STEP_PREFIX = "talp_steps_rank"
    #: recognised payload extensions, in collection preference order
    EXTS = (".npz", ".json")

    def __init__(self, spool_dir: str, world_size: Optional[int] = None,
                 payload: str = "binary"):
        if payload not in ("binary", "json"):
            raise ValueError(f"payload must be 'binary' or 'json', got {payload!r}")
        self.spool_dir = spool_dir
        self.world_size = world_size
        self.payload = payload
        os.makedirs(spool_dir, exist_ok=True)

    @property
    def _ext(self) -> str:
        return ".npz" if self.payload == "binary" else ".json"

    def _path(self, rank: int) -> str:
        return os.path.join(self.spool_dir, f"{self.PREFIX}{rank:05d}{self._ext}")

    def _sample_path(self, rank: int) -> str:
        return os.path.join(
            self.spool_dir, f"{self.SAMPLE_PREFIX}{rank:05d}{self._ext}"
        )

    def _find(self, rank: int, prefix: str) -> Optional[str]:
        for ext in self.EXTS:
            p = os.path.join(self.spool_dir, f"{prefix}{rank:05d}{ext}")
            if os.path.exists(p):
                return p
        return None

    def _publish(
        self,
        result: TalpResult,
        path: str,
        timelines: Optional[Dict[int, DeviceTimeline]] = None,
    ) -> str:
        # Atomic publish: a unique temp name per write (two writers
        # handed the same rank id must not interleave inside one temp
        # file), fsync before the rename (a crash mid-write must not
        # leave a torn file under the published name), then os.replace —
        # mergers only ever observe complete payloads.
        with _ovh.section("spool"):
            if path.endswith(".npz"):
                _fsync_write(path, result_to_spool_bytes(result, timelines),
                             "wb")
            else:
                _fsync_write(path, result_to_spool_json(result, timelines),
                             "w")
            return path

    def submit(
        self,
        result: TalpResult,
        rank: int,
        timelines: Optional[Dict[int, DeviceTimeline]] = None,
    ) -> str:
        return self._publish(result, self._path(rank), timelines)

    def submit_sample(
        self,
        result: TalpResult,
        rank: int,
        timelines: Optional[Dict[int, DeviceTimeline]] = None,
    ) -> str:
        """Publish this rank's latest mid-run snapshot (atomically
        overwritten on every call — the spool keeps one live snapshot per
        rank, next to the post-mortem ``talp_rank*`` files)."""
        return self._publish(result, self._sample_path(rank), timelines)

    def _scan_ranks(self, prefix: str) -> List[int]:
        try:
            names = os.listdir(self.spool_dir)
        except FileNotFoundError:
            return []
        ranks = set()
        for n in names:
            if not n.startswith(prefix):
                continue
            for ext in self.EXTS:
                if n.endswith(ext):
                    try:
                        ranks.add(int(n[len(prefix):-len(ext)]))
                    except ValueError:
                        pass
                    break
        return sorted(ranks)

    def spooled_ranks(self) -> List[int]:
        # SAMPLE_PREFIX does not share PREFIX as a prefix, so post-mortem
        # and snapshot files never alias each other in these scans.
        return self._scan_ranks(self.PREFIX)

    def sampled_ranks(self) -> List[int]:
        return self._scan_ranks(self.SAMPLE_PREFIX)

    def _check_stale(self, ranks: List[int]) -> None:
        # A spool dir is one job's artifact. Leftovers from a larger
        # previous run would silently merge into the new report; ranks
        # outside [0, world_size) are detectable — reject them.
        if self.world_size is not None and ranks and ranks[-1] >= self.world_size:
            raise ValueError(
                f"spool {self.spool_dir} contains rank {ranks[-1]} >= "
                f"world_size {self.world_size}; stale files from a previous "
                "job? use a fresh spool directory per job"
            )

    def ready(self) -> bool:
        ranks = self.spooled_ranks()
        self._check_stale(ranks)
        if self.world_size is None:
            return bool(ranks)
        return len(ranks) >= self.world_size

    def wait_for_ranks(
        self,
        max_wait: float,
        world_size: Optional[int] = None,
        poll: float = 0.05,
        backoff: float = 2.0,
        max_poll: float = 1.0,
    ) -> List[int]:
        """Deadline-based wait for straggler ranks: poll the spool with
        exponential backoff until ``world_size`` (defaulting to the
        transport's) rank files are present or ``max_wait`` seconds pass.
        Returns whatever ranks arrived — never raises; pair with
        ``merge(allow_missing=True)`` to proceed on a partial fleet."""
        return wait_for_ranks(
            self.spooled_ranks,
            world_size if world_size is not None else self.world_size,
            max_wait, poll=poll, backoff=backoff, max_poll=max_poll,
        )

    def collect(self) -> List[TalpResult]:
        ranks = self.spooled_ranks()
        self._check_stale(ranks)
        out = []
        for rank in ranks:
            path = self._find(rank, self.PREFIX)
            if path is not None:
                out.append(load_spool_payload(path)[0])
        return out

    def collect_tolerant(
        self,
        expected: Optional[int] = None,
        quarantine: bool = True,
    ) -> Tuple[Dict[int, TalpResult], List[QuarantinedSpool]]:
        """Fault-tolerant collection: read every rank payload that *can*
        be read, quarantine (never crash on) the rest.

        Unreadable payloads — truncated/zero-byte files, version
        mismatches, mangled JSON — are classified with a reason string
        and moved into ``<spool_dir>/quarantine/`` (with a
        ``.reason.json`` sidecar) so a re-merge stays clean; files whose
        rank id falls outside ``[0, expected)`` are quarantined as stale
        rather than raising like the strict path. Returns
        ``(results by rank, quarantined payload records)``.
        """
        world = expected if expected is not None else self.world_size
        results: Dict[int, TalpResult] = {}
        quarantined: List[QuarantinedSpool] = []

        def _quarantine(path: str, reason: str, rank: Optional[int]) -> None:
            dest = quarantine_spool(path, reason) if quarantine else None
            quarantined.append(QuarantinedSpool(
                path=path, reason=reason, rank=rank,
                quarantined_to=(os.path.relpath(dest, self.spool_dir)
                                if dest else None),
            ))

        for rank in self.spooled_ranks():
            path = self._find(rank, self.PREFIX)
            if path is None:
                continue
            if world is not None and rank >= world:
                _quarantine(
                    path,
                    f"rank id {rank} outside world size {world} "
                    "(stale file from a previous job?)",
                    rank,
                )
                continue
            try:
                results[rank] = read_spool_payload(path)[0]
            except SpoolPayloadError as e:
                _quarantine(path, str(e), rank)
        return results, quarantined

    def collect_timelines(self) -> Dict[int, Dict[int, DeviceTimeline]]:
        """Raw device-timeline attachments per spooled rank (empty dicts
        for ranks whose payload carries none)."""
        ranks = self.spooled_ranks()
        self._check_stale(ranks)
        out: Dict[int, Dict[int, DeviceTimeline]] = {}
        for rank in ranks:
            path = self._find(rank, self.PREFIX)
            if path is not None:
                out[rank] = load_spool_payload(path)[1]
        return out

    def merge(
        self,
        name: Optional[str] = None,
        allow_missing: bool = False,
        max_wait: Optional[float] = None,
        expected: Optional[int] = None,
    ) -> TalpResult:
        """Merge the spooled ranks into the job result.

        Strict by default: any unreadable payload raises, exactly as
        before. ``allow_missing=True`` switches to partial-rank mode:
        unreadable payloads are quarantined (see
        :meth:`collect_tolerant`), absent ranks are tolerated, and the
        result carries a ``rank_coverage`` annotation naming the
        expected/merged/missing/quarantined ranks. ``max_wait`` first
        waits (with poll backoff) up to that many seconds for straggler
        ranks to arrive; ``expected`` overrides the transport's
        ``world_size`` as the expectation coverage is measured against.
        """
        world = expected if expected is not None else self.world_size
        if max_wait is not None:
            self.wait_for_ranks(max_wait, world_size=world)
        if not allow_missing:
            results = self.collect()
            if not results:
                raise ValueError(f"no spooled results in {self.spool_dir}")
            return merge_results(results, name=name)
        by_rank, quarantined = self.collect_tolerant(expected=world)
        if not by_rank:
            raise ValueError(
                f"no readable spooled results in {self.spool_dir}"
                + (f" ({len(quarantined)} payload(s) quarantined)"
                   if quarantined else "")
            )
        coverage = RankCoverage.compute(
            merged=list(by_rank), expected=world, quarantined=quarantined
        )
        return merge_results(
            [by_rank[r] for r in sorted(by_rank)], name=name,
            coverage=coverage,
        )

    def collect_samples(self) -> List[TalpResult]:
        """Read every rank's latest mid-run snapshot currently present.

        Unlike :meth:`collect`, missing ranks are expected (a rank may not
        have published its first snapshot yet), so no staleness check —
        the job snapshot covers whichever ranks have reported so far.
        Unreadable snapshots are skipped rather than quarantined: the
        producer atomically overwrites its snapshot on the next sample,
        so moving the file aside would race with a live writer.
        """
        out = []
        for rank in self.sampled_ranks():
            path = self._find(rank, self.SAMPLE_PREFIX)
            if path is not None:
                try:
                    out.append(read_spool_payload(path)[0])
                except SpoolPayloadError:
                    continue
        return out

    def merge_samples(self, name: Optional[str] = None) -> TalpResult:
        """Job-level mid-run snapshot over the ranks sampled so far."""
        results = self.collect_samples()
        if not results:
            raise ValueError(f"no sample snapshots in {self.spool_dir}")
        return merge_samples(results, name=name)

    # -- step-resolution series -----------------------------------------
    def _step_path(self, rank: int) -> str:
        return os.path.join(
            self.spool_dir, f"{self.STEP_PREFIX}{rank:05d}.npz"
        )

    def submit_steps(self, series, rank: int) -> str:
        """Publish this rank's step series (atomic tmp + replace, like
        every spool write). Always NPZ — the structured row array *is*
        the schema, so readers need no hierarchy objects."""
        with _ovh.section("spool"):
            path = self._step_path(rank)
            buf = io.BytesIO()
            np.savez(buf, **series.to_arrays())
            _fsync_write(path, buf.getvalue(), "wb")
            return path

    def step_ranks(self) -> List[int]:
        return self._scan_ranks(self.STEP_PREFIX)

    def collect_steps(self) -> Dict[int, "object"]:
        """Read back every rank's spooled step series."""
        from .telemetry.stepseries import StepSeries

        out: Dict[int, StepSeries] = {}
        for rank in self.step_ranks():
            path = self._step_path(rank)
            if not os.path.exists(path):
                continue
            with np.load(path, allow_pickle=False) as npz:
                out[rank] = StepSeries.from_arrays(
                    rows=npz["rows"],
                    regions=npz["regions"],
                    n_total=int(npz["n_total"]),
                )
        return out

    def merge_steps(self, name: str = "job"):
        """Job-level per-step table across all spooled step series
        (see :func:`merge_step_series`)."""
        series = self.collect_steps()
        if not series:
            raise ValueError(f"no step-series spools in {self.spool_dir}")
        return merge_step_series(series, name=name)


class AllGatherTransport:
    """``torch.distributed`` collective exchange of result payloads.

    With an initialised ``torch.distributed`` process group of more than
    one rank, every rank contributes its JSON payload through
    ``all_gather_object`` and every rank returns the merged job result.
    On a single process — or when ``torch.distributed`` is unavailable or
    not initialised — it degenerates to a local merge, so call sites need
    no gating. ``max_bytes`` caps one rank's payload, as the fixed
    allgather buffer of the JAX transport does; ``group`` is the process
    group (default: the whole world).
    """

    def __init__(self, max_bytes: int = 1 << 20, group=None):
        self.max_bytes = max_bytes
        self.group = group

    def _world_size(self) -> int:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                return dist.get_world_size(self.group)
        except Exception:
            pass
        return 1

    def gather(self, result: TalpResult, name: Optional[str] = None) -> TalpResult:
        from .report import to_json

        n_proc = self._world_size()
        if n_proc <= 1:
            return merge_results([result], name=name)

        import torch.distributed as dist

        payload = to_json(result).encode("utf-8")
        if len(payload) > self.max_bytes:
            raise ValueError(
                f"result payload {len(payload)}B exceeds allgather buffer "
                f"{self.max_bytes}B; raise max_bytes"
            )
        gathered: List[object] = [None] * n_proc
        dist.all_gather_object(gathered, payload, group=self.group)
        # Decode each rank's payload defensively: a mangled or empty payload
        # (a rank that died between initializing the fleet and filling
        # its buffer, a producer-version skew) is quarantined with a
        # reason instead of failing the whole job report; the survivors
        # merge with a rank_coverage annotation.
        results: List[Tuple[int, TalpResult]] = []
        quarantined: List[QuarantinedSpool] = []
        for i, row in enumerate(gathered):
            try:
                if not row:
                    raise SpoolPayloadError("empty allgather payload")
                if not isinstance(row, (bytes, bytearray)):
                    raise SpoolPayloadError(
                        "mangled allgather payload",
                        f"a {type(row).__name__}, not bytes",
                    )
                if len(row) > self.max_bytes:
                    raise SpoolPayloadError(
                        "oversized allgather payload",
                        f"{len(row)}B over a {self.max_bytes}B buffer",
                    )
                results.append((i, talp_result_from_json(
                    bytes(row).decode("utf-8")
                )))
            except SpoolPayloadError as e:
                quarantined.append(QuarantinedSpool(
                    path=f"allgather rank {i}", reason=str(e), rank=i
                ))
            except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
                    TypeError, ValueError) as e:
                quarantined.append(QuarantinedSpool(
                    path=f"allgather rank {i}",
                    reason=f"mangled allgather payload "
                           f"({type(e).__name__}: {e})",
                    rank=i,
                ))
        if not results:
            raise ValueError(
                f"allgather produced no decodable payloads across "
                f"{n_proc} process(es)"
            )
        coverage = None
        if quarantined:
            coverage = RankCoverage.compute(
                merged=[i for i, _ in results], expected=n_proc,
                quarantined=quarantined,
            )
        return merge_results(
            [r for _, r in results], name=name, coverage=coverage
        )

    def gather_sample(
        self, result: TalpResult, name: Optional[str] = None
    ) -> TalpResult:
        """Collective job-level mid-run snapshot: every rank contributes
        its ``TalpMonitor.sample_result()`` and obtains the merged
        snapshot. Same exchange as :meth:`gather` — the snapshot merge
        algebra (:func:`merge_samples`) is identical to the post-mortem
        one, only the inputs differ."""
        return self.gather(result, name=name)


def merge_spool(
    spool_dir: str,
    name: Optional[str] = None,
    allow_missing: bool = False,
    max_wait: Optional[float] = None,
    expected: Optional[int] = None,
) -> TalpResult:
    """One-shot post-mortem merge of a rank spool directory (reads binary
    and legacy JSON payloads alike). ``allow_missing``/``max_wait``/
    ``expected`` select the fault-tolerant partial-rank mode — see
    :meth:`FileSpoolTransport.merge`."""
    return FileSpoolTransport(spool_dir).merge(
        name=name, allow_missing=allow_missing, max_wait=max_wait,
        expected=expected,
    )


def emit_job_report(
    result: TalpResult,
    spool_dir: str,
    rank: int,
    world_size: int,
    verbose: bool = True,
    payload: str = "binary",
    timelines: Optional[Dict[int, DeviceTimeline]] = None,
    fault_plan: Optional[FaultPlan] = None,
) -> Optional[TalpResult]:
    """Launcher-side helper: spool this rank's report; once all ranks are
    in, merge and publish ``<spool_dir>/talp_job.json``.

    Multiple ranks may pass ``ready()`` near-simultaneously; the merge is
    idempotent and the job file is published atomically (unique tmp +
    ``os.replace``), so concurrent writers are safe — readers only ever
    see a complete report. Returns the job result on the rank(s) that
    merged, ``None`` elsewhere. The merged ``talp_job.json`` is always
    JSON (the job-level artifact stays human-readable); ``payload``
    selects the per-rank spool format.

    ``fault_plan`` (a :class:`~repro.core.collect.FaultPlan` or spec) is
    the drivers' ``--talp-fault-plan`` debug hook: it can drop this
    rank's submit entirely, delay it, or mangle the published payload —
    deterministic failure injection for exercising the tolerant-merge
    path end to end. When a plan is active, any rank that does merge
    merges tolerantly (``allow_missing=True``), since injected faults
    make unreadable peers the *expected* outcome.
    """
    from .report import render_tables, to_json

    transport = FileSpoolTransport(spool_dir, world_size=world_size,
                                   payload=payload)
    if fault_plan is not None:
        fault_plan = FaultPlan.from_spec(fault_plan)
        if fault_plan.drops(rank):
            if verbose:
                print(f"[talp fault] rank {rank}: dropping spool submit")
            return None
        delay = fault_plan.delay_s(rank)
        if delay:
            if verbose:
                print(f"[talp fault] rank {rank}: delaying submit {delay}s")
            time.sleep(delay)
    path = transport.submit(result, rank=rank, timelines=timelines)
    if fault_plan is not None:
        done = fault_plan.apply_to_file(path, rank)
        if done and verbose:
            print(f"[talp fault] rank {rank}: {done}")
    if not transport.ready():
        return None
    job = transport.merge(name=result.name,
                          allow_missing=fault_plan is not None)
    _fsync_write(os.path.join(spool_dir, "talp_job.json"), to_json(job), "w")
    if verbose:
        print(render_tables(job))
    return job


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import sys

    from .report import render_tables, to_json

    ap = argparse.ArgumentParser(
        description="Merge a per-rank TALP spool into the job-level report."
    )
    ap.add_argument("spool_dir",
                    help="directory of talp_rank*.npz (binary, default "
                         "producer format) and/or talp_rank*.json (legacy) "
                         "spool files; formats are auto-detected and mix "
                         "freely")
    ap.add_argument("--name", default=None, help="job name for the report")
    ap.add_argument("--allow-missing-ranks", action="store_true",
                    help="fault-tolerant partial merge: quarantine "
                         "unreadable spool payloads (truncated/zero-byte/"
                         "version-mismatched/mangled) instead of failing, "
                         "tolerate absent ranks, and annotate the report "
                         "with a rank_coverage node naming the expected/"
                         "merged/missing/quarantined ranks")
    ap.add_argument("--max-wait", type=float, default=None, metavar="SECONDS",
                    help="wait up to this many seconds (polling with "
                         "backoff) for straggler rank files to appear "
                         "before merging; needs --expected-ranks to know "
                         "when the spool is complete")
    ap.add_argument("--expected-ranks", type=int, default=None, metavar="N",
                    help="the job's world size: coverage is measured "
                         "against ranks [0, N) (default: inferred from "
                         "the highest rank id observed in the spool)")
    ap.add_argument("--json-out", default=None,
                    help="also write the merged report as JSON")
    ap.add_argument("--samples", action="store_true",
                    help="merge mid-run talp_sample_rank* snapshots "
                         "instead of post-mortem rank files")
    ap.add_argument("--trace-out", default=None,
                    help="write a job-level Chrome/Perfetto trace JSON "
                         "built from the merged result (device lanes are "
                         "exact when rank payloads attach raw timelines)")
    ap.add_argument("--step-series", action="store_true",
                    help="also merge talp_steps_rank*.npz step-series "
                         "spools into a job-level per-step table "
                         "(rank-aligned by step index; host metrics "
                         "recomputed across ranks) and print it")
    args = ap.parse_args(argv)

    # Diagnose before FileSpoolTransport, whose constructor would
    # silently create the missing directory.
    if not os.path.isdir(args.spool_dir):
        print(f"error: spool directory {args.spool_dir!r} does not exist",
              file=sys.stderr)
        sys.exit(2)
    transport = FileSpoolTransport(args.spool_dir)
    if args.max_wait is not None and not args.samples:
        transport.wait_for_ranks(args.max_wait,
                                 world_size=args.expected_ranks)
    pattern = (transport.SAMPLE_PREFIX if args.samples else transport.PREFIX)
    ranks = transport.sampled_ranks() if args.samples else transport.spooled_ranks()
    if not ranks:
        print(
            f"error: no {pattern}*.json or {pattern}*.npz files found in "
            f"{args.spool_dir!r}; nothing to merge",
            file=sys.stderr,
        )
        sys.exit(2)
    try:
        if args.samples:
            job = transport.merge_samples(name=args.name)
        else:
            job = transport.merge(
                name=args.name,
                allow_missing=args.allow_missing_ranks,
                expected=args.expected_ranks,
            )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    print(render_tables(job))
    cov = job.rank_coverage
    if cov is not None and not cov.complete:
        print(f"warning: partial job report — {cov.summary()}; "
              f"missing={cov.missing} "
              f"quarantined={[q.rank for q in cov.quarantined]}",
              file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(to_json(job))
    if args.trace_out:
        from .telemetry.traceexport import export_job

        rank_tls = {} if args.samples else transport.collect_timelines()
        with open(args.trace_out, "w") as f:
            f.write(export_job(job, rank_tls))
        print(f"wrote Chrome trace: {args.trace_out}")
    if args.step_series:
        try:
            table = transport.merge_steps(name=args.name or job.name)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(2)
        n_ranks = len(transport.step_ranks())
        print(
            f"\nJob-level step series ({n_ranks} rank(s), "
            f"{len(table)} aligned steps):"
        )
        print(table.as_table())


if __name__ == "__main__":
    main()
