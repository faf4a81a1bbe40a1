"""Append-only JSONL perf history, keyed by (section, config identity).

The port's copy of the reader and writer of the reference's
``perfwatch/history.py``. One line per recorded measurement:

    {"section": "serve", "key": "serve/cpu/d12/n6",
     "recorded_at": "2026-08-03T12:00:00Z", "source": "serve-smoke",
     "payload": {...the bench payload verbatim...}}

The payload is stored verbatim so the detector can be spread-aware; the
``key`` collapses the identity fields (preset / kernel / mesh / backend,
difficulty, blocks, batch, miners) so that two different configurations
are never compared. ``SECTION_METRICS`` names each section's headline
metric and its direction (None: recorded, never judged against a
baseline; ``detector.SECTION_BOUNDS`` may bound it absolutely).

The repo's ``PERF_HISTORY.jsonl`` was written by the reference package;
the port reads it (the serve smoke judges its payload through the
detector) and records only into a file its caller names. The seeding from
the reference's bench round records belongs to the perfwatch CLI, which
is not ported yet.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import pathlib

DEFAULT_HISTORY_NAME = "PERF_HISTORY.jsonl"

# section -> (headline metric key, direction).
SECTION_METRICS: dict[str, tuple[str, str | None]] = {
    "sweep": ("hashes_per_sec_per_chip", "higher"),
    "chain": ("wall_s", "lower"),
    "tpu_single": ("hashes_per_sec", "higher"),
    "sharded_pallas": ("blocks_per_sec", "higher"),
    "cpu_np8": ("hashes_per_sec", "higher"),
    "sim_adversarial": ("steps_per_sec", "higher"),
    "utilization": ("vpu_utilization_pct", None),
    "trace_overhead": ("overhead_pct", None),
    "trace_block_observe": ("block_observe_us", None),
    "pipeline_bubble": ("bubble_fraction", None),
    "collective_skew": ("max_skew_ms", None),
    "compile_cache": ("recompiles_after_warmup", None),
    "serve": ("p99_latency_ms", None),
}

_KEY_FIELDS = ("preset", "kernel", "mesh", "backend")


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def entry_key(section: str, payload: dict) -> str:
    """Stable identity of a measurement series: section + the config
    fields that change what is being measured. Payloads missing a field
    simply omit it."""
    parts = [section]
    parts += [str(payload[f]) for f in _KEY_FIELDS if payload.get(f)]
    for field, tag in (("difficulty_bits", "d"), ("n_blocks", "n"),
                      ("batch_pow2", "b"), ("n_miners", "m")):
        if payload.get(field) is not None:
            parts.append(f"{tag}{payload[field]}")
    return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class Entry:
    section: str
    key: str
    recorded_at: str
    source: str
    payload: dict

    @property
    def metric(self) -> tuple[str, str | None]:
        return SECTION_METRICS[self.section]

    @property
    def value(self) -> float:
        return float(self.payload[self.metric[0]])

    @property
    def spread_pct(self) -> float:
        return float(self.payload.get("spread_pct", 0.0))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class HistoryStore:
    """The JSONL file, with append/read/group primitives."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)

    def record(self, section: str, payload: dict, source: str = "cli",
               recorded_at: str | None = None) -> Entry | None:
        """Appends one measurement. Returns None (and writes nothing)
        when the section is unknown or the payload lacks the section's
        headline metric."""
        spec = SECTION_METRICS.get(section)
        if spec is None or spec[0] not in payload:
            return None
        entry = Entry(section=section,
                      key=entry_key(section, payload),
                      recorded_at=recorded_at or _utc_now(),
                      source=source, payload=dict(payload))
        with self.path.open("a") as f:
            f.write(json.dumps(entry.to_dict(), sort_keys=True) + "\n")
        return entry

    def entries(self, section: str | None = None) -> list[Entry]:
        """All entries in file order; malformed lines and entries of
        sections this version does not know are skipped, so an old
        history never crashes a new reader."""
        if not self.path.exists():
            return []
        out: list[Entry] = []
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                e = Entry(section=d["section"], key=d["key"],
                          recorded_at=d.get("recorded_at", ""),
                          source=d.get("source", ""),
                          payload=d["payload"])
                e.value  # noqa: B018  validates section + metric present
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                continue
            if section is not None and e.section != section:
                continue
            out.append(e)
        return out

    def by_key(self, section: str | None = None) -> dict[str, list[Entry]]:
        grouped: dict[str, list[Entry]] = {}
        for e in self.entries(section):
            grouped.setdefault(e.key, []).append(e)
        return grouped
