"""Fault-tolerant distributed collection: coverage accounting, spool
quarantine, straggler deadlines, and deterministic fault injection.

Production job monitoring treats partial data as the common case, not an
error: ranks die, filesystems drop writes mid-file, stragglers arrive
after the deadline. This module gives the collection layer
(:mod:`repro.core.merge`) the vocabulary to *describe* those losses
instead of crashing on them:

  * :class:`RankCoverage` — the job report's ``rank_coverage`` node:
    which ranks were expected, which merged, which are missing, which
    payloads were quarantined (and why). Carried through the report JSON
    round trip, the text report, the telemetry exporter and the Chrome
    trace metadata.
  * :class:`QuarantinedSpool` + :func:`read_spool_payload` /
    :func:`quarantine_spool` — classify any unreadable spool payload
    (truncated NPZ, zero-byte file, version mismatch, mangled JSON …)
    with a human-readable reason and move it aside so a re-merge of the
    directory stays clean.
  * :func:`wait_for_ranks` — deadline-based wait for stragglers with
    exponential poll backoff; returns whatever arrived by the deadline
    (never raises).
  * :class:`FaultPlan` — a *deterministic* fault-injection layer (drop a
    rank, truncate/corrupt its payload bytes, delay its submit, skew its
    clock) usable from tests, benchmarks and the drivers'
    ``--talp-fault-plan`` debug flag. No randomness anywhere: a plan is
    an explicit JSON spec, so every injected failure reproduces exactly.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SpoolPayloadError",
    "SpoolVersionError",
    "QuarantinedSpool",
    "RankCoverage",
    "read_spool_payload",
    "quarantine_spool",
    "wait_for_ranks",
    "FaultPlan",
]

#: Subdirectory (of the spool dir) unreadable payloads are moved into.
QUARANTINE_DIRNAME = "quarantine"


class SpoolPayloadError(ValueError):
    """A spool payload could not be read; ``reason`` is a short
    human-readable classification (stable enough to grep logs for)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}{': ' + detail if detail else ''}")


class SpoolVersionError(SpoolPayloadError):
    """Payload carries a ``SPOOL_BINARY_VERSION`` this reader does not
    support (raised by the binary decoder, classified here)."""

    def __init__(self, detail: str = ""):
        super().__init__("unsupported spool payload version", detail)


@dataclass(frozen=True)
class QuarantinedSpool:
    """One payload the collector refused to merge, and why."""

    path: str
    reason: str
    rank: Optional[int] = None
    quarantined_to: Optional[str] = None

    def as_dict(self) -> Dict:
        d = {"path": os.path.basename(self.path), "reason": self.reason}
        if self.rank is not None:
            d["rank"] = self.rank
        if self.quarantined_to is not None:
            d["quarantined_to"] = self.quarantined_to
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "QuarantinedSpool":
        return cls(
            path=d.get("path", ""),
            reason=d.get("reason", "unknown"),
            rank=d.get("rank"),
            quarantined_to=d.get("quarantined_to"),
        )


@dataclass
class RankCoverage:
    """Which ranks the job report actually covers.

    ``expected`` is the job's world size (``None`` while unknown — the
    constructor helpers infer the densest consistent value from the
    observed rank ids). ``merged`` + ``missing`` + ranks of
    ``quarantined`` partition ``range(expected)`` when every rank id is
    known: *missing* ranks left no payload at all, *quarantined* ones
    left one the collector could not read.
    """

    expected: Optional[int]
    merged: List[int] = field(default_factory=list)
    missing: List[int] = field(default_factory=list)
    quarantined: List[QuarantinedSpool] = field(default_factory=list)

    @classmethod
    def compute(
        cls,
        merged: Sequence[int],
        expected: Optional[int] = None,
        quarantined: Sequence[QuarantinedSpool] = (),
    ) -> "RankCoverage":
        """Derive the missing set: every rank in ``range(expected)`` that
        neither merged nor left a quarantined payload. With no explicit
        ``expected``, the densest consistent world size (max observed
        rank id + 1) is inferred — ranks *above* every observed id are
        undetectable without an explicit expectation."""
        merged = sorted(set(int(r) for r in merged))
        quarantined = list(quarantined)
        seen = set(merged) | {
            q.rank for q in quarantined if q.rank is not None
        }
        if expected is None:
            expected = (max(seen) + 1) if seen else 0
        accounted = set(merged) | {
            q.rank for q in quarantined if q.rank is not None
        }
        missing = sorted(set(range(expected)) - accounted)
        return cls(
            expected=expected, merged=merged, missing=missing,
            quarantined=quarantined,
        )

    @property
    def complete(self) -> bool:
        return not self.missing and not self.quarantined

    def summary(self) -> str:
        exp = "?" if self.expected is None else str(self.expected)
        return f"{len(self.merged)}/{exp} rank(s) merged"

    def as_dict(self) -> Dict:
        return {
            "expected": self.expected,
            "merged": list(self.merged),
            "missing": list(self.missing),
            "quarantined": [q.as_dict() for q in self.quarantined],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "RankCoverage":
        return cls(
            expected=d.get("expected"),
            merged=[int(r) for r in d.get("merged") or []],
            missing=[int(r) for r in d.get("missing") or []],
            quarantined=[
                QuarantinedSpool.from_dict(q)
                for q in d.get("quarantined") or []
            ],
        )

    def render_text(self) -> str:
        """The text-report coverage block (see ``report.render_tables``)."""
        lines = [f"rank coverage: {self.summary()}"]
        if self.missing:
            lines.append(
                "  missing rank(s)    : "
                + ", ".join(str(r) for r in self.missing)
            )
        for q in self.quarantined:
            who = f"rank {q.rank}" if q.rank is not None else "unknown rank"
            lines.append(
                f"  quarantined payload: {who} "
                f"({os.path.basename(q.path)}): {q.reason}"
            )
        if self.complete:
            lines.append("  all expected ranks merged")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# defensive payload reading + quarantine
# ---------------------------------------------------------------------------
def read_spool_payload(path: str):
    """Read one spool file like ``merge.load_spool_payload`` but map
    every failure mode to a :class:`SpoolPayloadError` whose ``reason``
    names the corruption class — the collector's single choke point for
    deciding "merge or quarantine". Returns ``(result, timelines)``."""
    from .merge import load_spool_payload

    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise SpoolPayloadError("unreadable file", str(e)) from e
    if size == 0:
        raise SpoolPayloadError("zero-byte file")
    try:
        return load_spool_payload(path)
    except SpoolPayloadError:
        raise
    except (zipfile.BadZipFile, EOFError) as e:
        raise SpoolPayloadError(
            "truncated or non-NPZ binary payload", str(e)
        ) from e
    except json.JSONDecodeError as e:
        raise SpoolPayloadError("mangled JSON payload", str(e)) from e
    except UnicodeDecodeError as e:
        raise SpoolPayloadError("undecodable payload text", str(e)) from e
    except (KeyError, IndexError, TypeError, ValueError, OSError) as e:
        # np.load raises plain ValueError on mangled NPZ members; a
        # structurally wrong header lands in KeyError/TypeError.
        raise SpoolPayloadError(
            "malformed payload structure", f"{type(e).__name__}: {e}"
        ) from e


def quarantine_spool(
    path: str, reason: str, quarantine_dir: Optional[str] = None
) -> Optional[str]:
    """Move an unreadable payload into ``<dir>/quarantine/`` (with a
    ``.reason.json`` sidecar recording why) so re-merging the spool
    directory stays clean. Best-effort: on any filesystem error the file
    is left in place and ``None`` is returned — quarantine must never
    introduce a new crash into the collection path."""
    qdir = quarantine_dir or os.path.join(
        os.path.dirname(path) or ".", QUARANTINE_DIRNAME
    )
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        shutil.move(path, dest)
        with open(dest + ".reason.json", "w") as f:
            json.dump({"path": os.path.basename(path), "reason": reason}, f)
        return dest
    except OSError:
        return None


# ---------------------------------------------------------------------------
# straggler deadline
# ---------------------------------------------------------------------------
def wait_for_ranks(
    list_ranks: Callable[[], List[int]],
    world_size: Optional[int],
    max_wait: float,
    poll: float = 0.05,
    backoff: float = 2.0,
    max_poll: float = 1.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> List[int]:
    """Poll ``list_ranks()`` until ``world_size`` ranks are present or
    ``max_wait`` seconds elapse, with exponential poll backoff (``poll``
    doubling up to ``max_poll``). Returns the final rank list — whatever
    arrived by the deadline; deciding whether that is enough is the
    caller's policy (``allow_missing``), not this function's."""
    deadline = clock() + max(0.0, max_wait)
    ranks = list_ranks()
    while world_size is not None and len(ranks) < world_size:
        remaining = deadline - clock()
        if remaining <= 0:
            break
        sleep(min(poll, remaining))
        poll = min(poll * backoff, max_poll)
        ranks = list_ranks()
    return ranks


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------
@dataclass
class FaultPlan:
    """A reproducible fault-injection plan, keyed by rank id.

    Spec (JSON object, every section optional)::

        {
          "drop": [2],                  # ranks that never submit
          "truncate": {"1": 96},       # keep only the first N bytes
          "corrupt": {"0": {"offset": 64, "length": 16, "xor": 255}},
          "delay": {"1": 0.25},        # seconds to sleep before submit
          "clock_skew": {"0": 1.5}     # seconds added to the rank clock
        }

    ``from_spec`` accepts the dict itself, a JSON string, or ``@path`` /
    an existing file path pointing at a JSON file — the form the drivers'
    ``--talp-fault-plan`` flag takes. Everything is explicit: no RNG, so
    a failing CI scenario replays bit-identically.
    """

    drop: List[int] = field(default_factory=list)
    truncate: Dict[int, int] = field(default_factory=dict)
    corrupt: Dict[int, Dict[str, int]] = field(default_factory=dict)
    delay: Dict[int, float] = field(default_factory=dict)
    clock_skew: Dict[int, float] = field(default_factory=dict)

    @classmethod
    def from_spec(cls, spec) -> "FaultPlan":
        if isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, str):
            text = spec
            if spec.startswith("@"):
                with open(spec[1:]) as f:
                    text = f.read()
            elif not spec.lstrip().startswith("{") and os.path.exists(spec):
                with open(spec) as f:
                    text = f.read()
            try:
                spec = json.loads(text)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"fault plan is neither a JSON object nor a readable "
                    f"JSON file: {e}"
                ) from e
        if not isinstance(spec, dict):
            raise ValueError(f"fault plan spec must be a JSON object, "
                             f"got {type(spec).__name__}")
        known = {"drop", "truncate", "corrupt", "delay", "clock_skew"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"unknown fault plan section(s) {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(
            drop=[int(r) for r in spec.get("drop") or []],
            truncate={
                int(r): int(n) for r, n in (spec.get("truncate") or {}).items()
            },
            corrupt={
                int(r): {k: int(v) for k, v in c.items()}
                for r, c in (spec.get("corrupt") or {}).items()
            },
            delay={
                int(r): float(s) for r, s in (spec.get("delay") or {}).items()
            },
            clock_skew={
                int(r): float(s)
                for r, s in (spec.get("clock_skew") or {}).items()
            },
        )

    # -- queries ---------------------------------------------------------
    def drops(self, rank: int) -> bool:
        return rank in self.drop

    def delay_s(self, rank: int) -> float:
        return self.delay.get(rank, 0.0)

    def skew_s(self, rank: int) -> float:
        return self.clock_skew.get(rank, 0.0)

    def touches(self, rank: int) -> bool:
        return (
            self.drops(rank) or rank in self.truncate
            or rank in self.corrupt or rank in self.delay
            or rank in self.clock_skew
        )

    # -- application -----------------------------------------------------
    def mutate_bytes(self, data: bytes, rank: int) -> Optional[bytes]:
        """The plan's effect on an in-memory payload: ``None`` when the
        rank is dropped, otherwise the (possibly truncated/corrupted)
        bytes. Used by array-exchange transports and tests."""
        if self.drops(rank):
            return None
        if rank in self.truncate:
            data = data[: max(0, self.truncate[rank])]
        if rank in self.corrupt:
            c = self.corrupt[rank]
            off = c.get("offset", 0)
            length = c.get("length", 1)
            x = c.get("xor", 0xFF)
            buf = bytearray(data)
            for i in range(off, min(len(buf), off + length)):
                buf[i] ^= x
            data = bytes(buf)
        return data

    def apply_to_file(self, path: str, rank: int) -> Optional[str]:
        """Apply truncate/corrupt sections to an already-published spool
        file in place; returns a description of what was done (``None``
        when the plan leaves this rank's file untouched)."""
        done = []
        if rank in self.truncate:
            os.truncate(path, max(0, self.truncate[rank]))
            done.append(f"truncated to {max(0, self.truncate[rank])}B")
        if rank in self.corrupt:
            c = self.corrupt[rank]
            off = c.get("offset", 0)
            length = c.get("length", 1)
            x = c.get("xor", 0xFF)
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                n = max(0, min(size - off, length))
                if n:
                    f.seek(off)
                    chunk = bytearray(f.read(n))
                    for i in range(len(chunk)):
                        chunk[i] ^= x
                    f.seek(off)
                    f.write(bytes(chunk))
            done.append(f"xor-corrupted {length}B at offset {off}")
        return "; ".join(done) if done else None

    def describe(self, rank: int) -> str:
        """Human-readable summary of this rank's injected faults."""
        parts = []
        if self.drops(rank):
            parts.append("drop submit")
        if rank in self.truncate:
            parts.append(f"truncate to {self.truncate[rank]}B")
        if rank in self.corrupt:
            parts.append("corrupt bytes")
        if self.delay_s(rank):
            parts.append(f"delay submit {self.delay_s(rank)}s")
        if self.skew_s(rank):
            parts.append(f"clock skew {self.skew_s(rank):+}s")
        return ", ".join(parts) if parts else "no faults"
