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
detector) and records only into a file its caller names.

Seeding: ``seed_from_bench_rounds`` imports the repo's ``BENCH_r0*.json``
round records (fresh measurements only: a ``cached`` payload re-reports
an earlier fresh run) and ``BENCH_CACHE.json`` (which carries
``measured_at``), de-duplicating on equal metric values, as the
reference does. Those records are the reference's, taken on a TPU; the
port's own bench payloads carry ``backend`` (``"cuda"`` on the card), so
their keys never meet a seeded one.
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
               recorded_at: str | None = None,
               dedupe: bool = False) -> Entry | None:
        """Appends one measurement. Returns None (and writes nothing)
        when the section is unknown, the payload lacks the section's
        headline metric, or ``dedupe`` finds the same value already
        recorded for this key (the seeding path: a ``cached`` payload
        re-reports an earlier fresh run)."""
        spec = SECTION_METRICS.get(section)
        if spec is None or spec[0] not in payload:
            return None
        entry = Entry(section=section,
                      key=entry_key(section, payload),
                      recorded_at=recorded_at or _utc_now(),
                      source=source, payload=dict(payload))
        if dedupe:
            prior = [e for e in self.entries() if e.key == entry.key]
            if any(e.value == entry.value for e in prior):
                return None
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


# ---- seeding from the repo's bench records --------------------------------

# The reference's bench.py report nests section payloads under these
# detail keys.
_DETAIL_SECTIONS = {
    "tpu": "sweep",
    "chain_1000_diff24": "chain",
    "tpu_single": "tpu_single",
    "sharded_pallas": "sharded_pallas",
    "cpu_np8": "cpu_np8",
    "sim_adversarial": "sim_adversarial",
    "utilization": "utilization",
}


def _parse_round_report(path: pathlib.Path) -> dict | None:
    """A BENCH_r0N.json file: {"parsed": {...}} when the run's output was
    parsed, else the raw "tail" whose LAST parseable JSON line is the
    report (the tail may be cut at the front)."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    report = None
    for line in str(doc.get("tail", "")).splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(d, dict) and "metric" in d:
            report = d
    return report


def import_bench_report(store: HistoryStore, report: dict, source: str,
                        dedupe: bool = True,
                        default_recorded_at: str | None = None) -> int:
    """Records every fresh section payload of one bench report dict and
    returns how many. ``cached`` payloads are skipped: they re-report an
    earlier fresh measurement and would flatten the trajectory.
    ``default_recorded_at`` stamps payloads that carry no
    ``measured_at`` of their own, so a backfill lands in the past (the
    detector picks its candidate by ``recorded_at``, not file position)."""
    detail = report.get("detail", report)
    if not isinstance(detail, dict):
        return 0
    n = 0
    for key, section in _DETAIL_SECTIONS.items():
        payload = detail.get(key)
        if not isinstance(payload, dict) or payload.get("cached"):
            continue
        if store.record(section, payload, source=source,
                        recorded_at=(payload.get("measured_at")
                                     or default_recorded_at),
                        dedupe=dedupe):
            n += 1
    return n


def _parse_iso_z(s) -> datetime.datetime | None:
    try:
        return datetime.datetime.strptime(
            str(s), "%Y-%m-%dT%H:%M:%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except (TypeError, ValueError):
        return None


def seed_from_bench_rounds(store: HistoryStore,
                           root: str | pathlib.Path) -> dict:
    """Imports BENCH_r0*.json (round order) and BENCH_CACHE.json into the
    store. Returns {"rounds": n_files, "recorded": n_entries, "skipped":
    unparseable_files}.

    The round records carry no timestamps of their own, and the cache
    holds the newest numbers. So round i of N is stamped ``anchor - (N -
    i) minutes``, where ``anchor`` is the oldest ``measured_at`` in the
    cache (now, without one): the rounds keep their order, and every
    seeded round sits before the cache and before any later append."""
    root = pathlib.Path(root)
    cache_path = root / "BENCH_CACHE.json"
    cache: dict = {}
    if cache_path.exists():
        try:
            cache = json.loads(cache_path.read_text())
        except (OSError, json.JSONDecodeError):
            cache = {}
    stamps = [t for ent in cache.values() if isinstance(ent, dict)
              for t in [_parse_iso_z(ent.get("measured_at"))] if t]
    anchor = min(stamps, default=datetime.datetime.now(
        datetime.timezone.utc))
    round_paths = sorted(root.glob("BENCH_r[0-9]*.json"))
    recorded, skipped = 0, []
    for i, path in enumerate(round_paths):
        report = _parse_round_report(path)
        if report is None:
            skipped.append(path.name)
            continue
        stamp = (anchor - datetime.timedelta(
            minutes=len(round_paths) - i)).strftime("%Y-%m-%dT%H:%M:%SZ")
        recorded += import_bench_report(store, report, source=path.name,
                                        default_recorded_at=stamp)
    for section, ent in sorted(cache.items()):
        if not (isinstance(ent, dict) and isinstance(
                ent.get("payload"), dict)):
            continue
        # Cache keys are history section names; unknown ones (a
        # determinism record such as "sharded_chain") fall out of
        # record() as a no-op.
        if store.record(section, ent["payload"], source="BENCH_CACHE.json",
                        recorded_at=ent.get("measured_at"), dedupe=True):
            recorded += 1
    return {"rounds": len(round_paths), "recorded": recorded,
            "skipped": skipped}
