"""Roofline-driven stage autotuner with a deterministic cutout harness
(port of ``repro/launch/tuner.py``, DESIGN.md §16).

The schedule knobs of the decoupled lane (the fwd:bwd ratio R, the update
delay D, the layer grouping, the engine's ``max_inflight_steps`` and the
gossip tile) are scored on measured stage times: cut each stage out of the
engine, time it alone, score a small grid against roofline floors and the
measured overlap, and emit the winner as a :class:`TuningRecord` that
``ProdTrainerBackend(tuning=...)`` loads in place of the hand-picked
defaults.

* **Cutouts** (:class:`StageCutout`, :func:`extract_cutouts`): the port's
  engines expose ``stage_cutouts()`` (``PipelineEngine``: ``fwd0..``,
  ``update``, ``gossip``; ``StreamEngine``: the gossip stage per group,
  ``mix:<group>``, and ``clock``), each stage with its abstract argument
  signature: ``(shape, dtype)`` pairs, the type ``int`` for a host integer,
  ``None`` for an absent argument. :func:`synthesize_args` makes fresh
  buffers of ones on the engine's device for every call (the stages
  consume their inputs in place, as the reference's donate them).
* **Harness** (:class:`CutoutHarness`): times a cutout over warmup and
  measured repetitions with an injectable clock and runner. The default
  runner runs the stage and synchronizes its device; the default clock on
  CUDA reads CUDA events (:class:`CudaEventClock`), elsewhere
  ``time.perf_counter``. Tests drive the whole grid with a scripted clock.
* **Scoring and record** (:func:`score_candidate`, :func:`build_record`,
  :class:`TuningRecord`): copied from the JAX package, value for value,
  and the JSON record format with them: a record written by either
  package loads in the other. The key is not interchangeable:
  :func:`mesh_descriptor` names the device, the worker count M and,
  over a ``WorkerMesh`` with a process group, the world of ranks.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = [
    "TUNING_SCHEMA_VERSION", "Candidate", "DEFAULT_CANDIDATE",
    "StageCutout", "CutoutHarness", "TuningRecord",
    "apply_tuning", "build_record", "enumerate_grid", "extract_cutouts",
    "load_tuning", "make_key", "mesh_descriptor", "overlap_efficiency",
    "problem_descriptor", "resolve_tuning", "score_candidate",
    "stage_times_from_cutouts", "synthesize_args", "CudaEventClock",
]

# bump whenever the record layout or the scoring semantics change: a loader
# seeing another version treats the record as stale and falls back to the
# hand-picked defaults (never apply a schedule tuned under different rules)
TUNING_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Candidate:
    """One point of the schedule grid.

    ``grouping``: ``"layer"`` is the per-layer-group flat plane
    (DESIGN.md §11 — one contiguous buffer per layer group, per-group
    signals on the stream engine); ``"legacy"`` is the per-leaf tree
    state with the per-step f32 ravel wire. ``tile`` is the
    gossip/quantize lane-row tile (the Pallas kernels pin 128 rows
    today, so other values score a modeled launch/padding penalty and
    are recorded for the kernel lane rather than applied)."""

    R: int = 2
    D: int = 1
    grouping: str = "layer"
    max_inflight_steps: int = 3
    tile: int = 128

    def label(self) -> str:
        return (f"R{self.R}_D{self.D}_{self.grouping}"
                f"_q{self.max_inflight_steps}_t{self.tile}")


#: the hand-picked defaults every PR so far shipped (R=2/D=1 from the
#: paper, flat plane, max_inflight_steps=3, 128-lane kernel rows) — the
#: baseline a tuned schedule must never score below.
DEFAULT_CANDIDATE = Candidate()


def enumerate_grid(R_values: Sequence[int] = (1, 2, 4),
                   D_values: Sequence[int] = (0, 1, 2),
                   groupings: Sequence[str] = ("layer",),
                   max_inflight: Sequence[int] = (2, 3, 4),
                   tiles: Sequence[int] = (128,)) -> List[Candidate]:
    """The config grid, in a deterministic nested order (R outermost).

    Pure enumeration — no filtering, no timing, no randomness — so tests
    pin the exact candidate list."""
    out = []
    for r in R_values:
        for d in D_values:
            for g in groupings:
                for q in max_inflight:
                    for t in tiles:
                        out.append(Candidate(R=int(r), D=int(d),
                                             grouping=str(g),
                                             max_inflight_steps=int(q),
                                             tile=int(t)))
    return out


# ---------------------------------------------------------------------------
# cutouts
# ---------------------------------------------------------------------------


@dataclass
class StageCutout:
    """One stage cut out of an engine: the callable, the abstract argument
    signature to make its inputs from, and the device they live on."""

    name: str
    fn: Callable
    abstract_args: tuple
    device: Any = None


def extract_cutouts(engine) -> Dict[str, StageCutout]:
    """Every stage of a :class:`~repro_torch.launch.pipeline.PipelineEngine`
    or :class:`~repro_torch.launch.streams.StreamEngine` as an independently
    runnable cutout on the engine's device. Raises ``ValueError`` if the
    engine carries no abstract argument signatures, or before the first
    step of a backend's engine has recorded the batch's
    (``engine.stage_cutouts()`` owns both checks)."""
    return {name: StageCutout(name, fn, args, engine.device)
            for name, (fn, args) in engine.stage_cutouts().items()}


def _is_spec(node) -> bool:
    return (isinstance(node, tuple) and len(node) == 2
            and isinstance(node[1], torch.dtype))


def synthesize_args(abstract_args, device=None):
    """Fresh concrete buffers for an abstract argument signature, on
    ``device`` (default CUDA, which must exist).

    Every ``(shape, dtype)`` pair becomes a tensor of ones (ones, not
    zeros: push-sum weights and version clocks stay benign), the type
    ``int`` the host integer ``1`` (a valid step and, with two or more
    shifts, shift index), ``None`` stays ``None``. A NEW tree is built per
    call: the stages consume their inputs in place, so a cutout invocation
    must never reuse a buffer a previous one consumed."""
    dev = resolve_device(device)

    def mk(node):
        if node is int:
            return 1
        if _is_spec(node):
            return torch.ones(tuple(node[0]), dtype=node[1], device=dev)
        if isinstance(node, dict):
            return {k: mk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(mk(v) for v in node)
        return node

    return mk(abstract_args)


def _devices(tree, out=None) -> set:
    out = set() if out is None else out
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def _default_runner(fn, args):
    """Run a stage and wait until the devices of its inputs are idle: the
    real-timing backend (the injectable seam for tests)."""
    out = fn(*args)
    for dev in _devices(args):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


class CudaEventClock:
    """Seconds on a CUDA device's clock: each reading records an event on
    the current stream, waits for it, and returns the elapsed time since a
    base event recorded at construction."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        with torch.cuda.device(self.device):
            self._base = torch.cuda.Event(enable_timing=True)
            self._base.record()
            self._base.synchronize()

    def __call__(self) -> float:
        with torch.cuda.device(self.device):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
        return self._base.elapsed_time(ev) / 1e3


def default_clock(device) -> Callable[[], float]:
    """CUDA events on a CUDA device, ``time.perf_counter`` elsewhere."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return CudaEventClock(dev)
    return time.perf_counter


class CutoutHarness:
    """Times stage cutouts in isolation with injectable clock + runner.

    ``clock`` is read immediately before and after each measured
    repetition ONLY (warmup repetitions never touch it), so a scripted
    clock maps one tick pair per rep and the arithmetic is exact in
    tests; ``None`` picks :func:`default_clock` of each cutout's device.
    ``runner(fn, args)`` performs the execution; the default runs the stage
    and synchronizes its device. Arguments are made anew for every
    invocation (see :func:`synthesize_args`)."""

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 runner: Optional[Callable] = None, warmup: int = 1,
                 reps: int = 3):
        if reps < 1:
            raise ValueError(f"need at least one measured rep, got {reps}")
        self.clock = clock
        self.runner = runner if runner is not None else _default_runner
        self.warmup = int(warmup)
        self.reps = int(reps)
        self._clocks: Dict[Any, Callable[[], float]] = {}

    def _clock_for(self, device) -> Callable[[], float]:
        if self.clock is not None:
            return self.clock
        if device not in self._clocks:
            self._clocks[device] = default_clock(device)
        return self._clocks[device]

    def time_cutout(self, cutout: StageCutout) -> Dict[str, float]:
        def args():
            return synthesize_args(cutout.abstract_args, cutout.device)

        for _ in range(self.warmup):
            self.runner(cutout.fn, args())
        clock = self._clock_for(cutout.device)
        samples = []
        for _ in range(self.reps):
            a = args()
            t0 = clock()
            self.runner(cutout.fn, a)
            samples.append(clock() - t0)
            del a
        return {"mean_s": sum(samples) / len(samples),
                "best_s": min(samples), "reps": float(self.reps)}

    def time_engine(self, engine) -> Dict[str, Dict[str, float]]:
        """Time every cutout of an engine: ``{cutout_name: timing}``."""
        return {name: self.time_cutout(c)
                for name, c in extract_cutouts(engine).items()}


def stage_times_from_cutouts(timings: Dict[str, Dict[str, float]],
                             reduce: str = "mean_s") -> Dict[str, float]:
    """Collapse per-cutout timings into the three canonical stage times
    the scorer consumes: ``fwd`` (mean per forward slice), ``update``,
    and ``gossip`` (the full-plane stage, or the sum of the per-group
    mixes + the clock on the stream engine)."""
    fwd = [v[reduce] for n, v in timings.items() if n.startswith("fwd")]
    out = {"fwd": (sum(fwd) / len(fwd)) if fwd else 0.0,
           "update": timings.get("update", {}).get(reduce, 0.0)}
    if "gossip" in timings:
        out["gossip"] = timings["gossip"][reduce]
    else:
        out["gossip"] = (sum(v[reduce] for n, v in timings.items()
                             if n.startswith("mix:"))
                         + timings.get("clock", {}).get(reduce, 0.0))
    return out


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def overlap_efficiency(timeline_summary: Optional[Dict[str, Any]]) -> float:
    """Fraction of the wall the measured timeline proved overlapped, in
    [0, 1]. ``None`` means "no measurement" and scores as ideal (1.0 —
    pure-model ranking); an EMPTY timeline (zero closed steps) scores
    0.0 without dividing by zero."""
    if timeline_summary is None:
        return 1.0
    wall = float(timeline_summary.get("wall_s") or 0.0)
    if wall <= 0.0:
        return 0.0
    ov = max(float(timeline_summary.get("exec_overlap_s", 0.0)),
             float(timeline_summary.get("fwd_gossip_overlap_s", 0.0)),
             float(timeline_summary.get("overlap_s", 0.0)))
    return min(1.0, max(0.0, ov / wall))


def score_candidate(cand: Candidate, stage_times: Dict[str, float], *,
                    floors: Optional[Dict[str, float]] = None,
                    timeline: Optional[Dict[str, Any]] = None,
                    staleness_penalty: float = 0.1,
                    legacy_gossip_factor: float = 2.0) -> Dict[str, float]:
    """Deterministic throughput score for one candidate. Higher is
    better.

    The model, term by term:

    * stage times come from the cutout harness (``fwd`` is PER SLICE);
      ``floors`` — per-stage roofline lower bounds from
      :func:`repro_torch.launch.analysis.stage_floors` — clamp any measured
      time that claims to beat the hardware;
    * ``grouping="legacy"`` multiplies the gossip time by
      ``legacy_gossip_factor`` (the per-step f32 ravel repack + the f32
      wire, vs. the zero-repack param-dtype plane: the JAX package's
      factor; the port runs ``flat=False`` on the flat plane, so it has no
      legacy route to measure); off-128 tiles pay
      a modeled launch
      (smaller) or padding (larger) penalty;
    * one step runs R forward slices against the update+gossip tail.
      Fully serial that costs ``R·t_fwd + t_upd + t_gossip``; fully
      overlapped, ``max(R·t_fwd, t_upd + t_gossip)``. The schedule
      recovers the gap in proportion to (a) the overlap efficiency the
      MEASURED timeline demonstrated and (b) the pipeline depth the
      candidate affords (``1 − 2^−(max_inflight_steps + D)`` — each
      extra in-flight step or FIFO slot halves the remaining stall);
    * the score is forward passes per second (R per step — the paper's
      throughput currency) discounted by the staleness the schedule
      induces: ``D`` full delay slots plus ``(R−1)/2`` of forward
      run-ahead.

    Pure arithmetic over its inputs — the unit tests drive it with
    hand-written times and pin exact values."""
    t_fwd = float(stage_times["fwd"])
    t_upd = float(stage_times["update"])
    t_gos = float(stage_times["gossip"])
    if cand.grouping == "legacy":
        t_gos *= float(legacy_gossip_factor)
    if cand.tile < 128:
        t_gos *= 1.0 + 0.05 * (128.0 / cand.tile - 1.0)
    elif cand.tile > 128:
        t_gos *= 1.0 + 0.02 * (cand.tile / 128.0 - 1.0)
    if floors:
        t_fwd = max(t_fwd, float(floors.get("fwd", 0.0)))
        t_upd = max(t_upd, float(floors.get("update", 0.0)))
        t_gos = max(t_gos, float(floors.get("gossip", 0.0)))

    R = max(int(cand.R), 1)
    serial = R * t_fwd + t_upd + t_gos
    critical = max(R * t_fwd, t_upd + t_gos)
    eff = overlap_efficiency(timeline)
    depth = 1.0 - 0.5 ** max(int(cand.max_inflight_steps) + int(cand.D), 1)
    step_time = serial - eff * depth * (serial - critical)

    staleness = float(cand.D) + 0.5 * (R - 1)
    discount = 1.0 / (1.0 + float(staleness_penalty) * staleness)
    score = (R * discount / step_time) if step_time > 0.0 else 0.0
    return {"score": score, "step_time_s": step_time, "serial_s": serial,
            "critical_s": critical, "staleness": staleness,
            "overlap_eff": eff}


# ---------------------------------------------------------------------------
# the tuning record
# ---------------------------------------------------------------------------


def mesh_descriptor(device, M: int, world: int = 1) -> str:
    """Key component naming where the workers run: the device (its type and,
    on CUDA, the card's name), the worker count and, for M workers spread
    over ``world > 1`` ranks of a process group (a ``WorkerMesh``'s
    ``world``), the world, e.g. ``cuda:NVIDIA H100 80GB HBM3:M4`` and
    ``cuda:NVIDIA H100 80GB HBM3:M4:world2``: a schedule tuned on one
    process is not taken for a ranked one. The keys are not interchangeable
    with the JAX package's (``data4xmodel1``); the JSON record format is."""
    dev = torch.device(device)
    name = dev.type
    if dev.type == "cuda":
        name = f"cuda:{torch.cuda.get_device_name(dev)}"
    ranks = f":world{int(world)}" if int(world) > 1 else ""
    return f"{name}:M{int(M)}{ranks}"


def problem_descriptor(part) -> str:
    """Key component pinning the model's flat-plane layout (a
    :class:`~repro_torch.core.layerview.FlatPartition`): group names +
    sizes —
    two models tune interchangeably iff their planes match."""
    items = sorted((str(n), int(s)) for n, s in part.group_sizes.items())
    return "plane[" + ",".join(f"{n}:{s}" for n, s in items) + "]"


def make_key(problem: str, mesh_desc: str, wire: str) -> str:
    """The record key: model config + mesh descriptor + wire dtype."""
    return f"{problem}|{mesh_desc}|wire={wire}"


@dataclass
class TuningRecord:
    """A versioned, keyed tuning result — what the autotuner emits and
    ``ProdTrainerBackend`` loads."""

    version: int
    key: str
    best: Dict[str, Any]
    score: float
    table: List[Dict[str, Any]] = field(default_factory=list)
    stage_times: Dict[str, float] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def best_candidate(self) -> Candidate:
        names = {f.name for f in fields(Candidate)}
        return Candidate(**{k: v for k, v in self.best.items()
                            if k in names})

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "TuningRecord":
        if not isinstance(doc, dict):
            raise ValueError(f"tuning record must be a dict, got "
                             f"{type(doc).__name__}")
        for req in ("version", "key", "best", "score"):
            if req not in doc:
                raise ValueError(f"tuning record missing field {req!r}")
        best = doc["best"]
        if not isinstance(best, dict):
            raise ValueError("tuning record 'best' must be a dict")
        for req in ("R", "D"):
            if req not in best:
                raise ValueError(f"tuning record best missing {req!r}")
        rec = cls(version=int(doc["version"]), key=str(doc["key"]),
                  best=dict(best), score=float(doc["score"]),
                  table=list(doc.get("table", [])),
                  stage_times=dict(doc.get("stage_times", {})),
                  meta=dict(doc.get("meta", {})))
        rec.best_candidate()  # validates the candidate fields coerce
        return rec

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path


def build_record(entries: Iterable[Tuple[Candidate, Dict[str, float],
                                         Optional[Dict[str, Any]]]], *,
                 key: str, floors: Optional[Dict[str, float]] = None,
                 staleness_penalty: float = 0.1,
                 meta: Optional[Dict[str, Any]] = None) -> TuningRecord:
    """Score measured candidates and emit the record.

    ``entries`` — ``(candidate, stage_times, timeline_summary)`` triples
    (timeline may be None). ``floors`` is a per-stage dict, or a callable
    ``cand -> dict`` when the floor depends on the candidate (the fwd
    roofline floor divides by R — ``analysis.stage_floors(report,
    R=cand.R)``). The best candidate is the max score; ties break toward
    the EARLIEST entry, so putting the hand-picked default first
    guarantees "tuned never scores worse than untuned" degrades to the
    default under exact ties. The table keeps every scored row, sorted
    best-first."""
    rows = []
    for i, (cand, stage_times, timeline) in enumerate(entries):
        fl = floors(cand) if callable(floors) else floors
        s = score_candidate(cand, stage_times, floors=fl,
                            timeline=timeline,
                            staleness_penalty=staleness_penalty)
        rows.append((s["score"], -i, cand, stage_times, s))
    if not rows:
        raise ValueError("build_record needs at least one scored candidate")
    rows.sort(key=lambda r: (r[0], r[1]), reverse=True)
    best_score, _, best, best_times, best_s = rows[0]
    table = [{**asdict(c), **s, "label": c.label()}
             for _, _, c, _, s in rows]
    return TuningRecord(
        version=TUNING_SCHEMA_VERSION, key=key,
        best={**asdict(best), "label": best.label()}, score=best_score,
        table=table, stage_times=dict(best_times), meta=dict(meta or {}))


# ---------------------------------------------------------------------------
# loading + applying (the ProdTrainerBackend entry point)
# ---------------------------------------------------------------------------


def _warn(msg: str) -> None:
    warnings.warn(f"tuning record: {msg}; falling back to hand-picked "
                  f"defaults", UserWarning, stacklevel=3)


def load_tuning(path: str, *, key: Optional[str] = None,
                version: int = TUNING_SCHEMA_VERSION
                ) -> Optional[TuningRecord]:
    """Load a record from JSON; NEVER raises. A missing file, corrupted
    JSON, a stale/foreign schema version, a key mismatch or a malformed
    body each warn and return ``None`` — the caller keeps its
    hand-picked defaults."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except Exception as e:
        _warn(f"{path!r} unreadable ({type(e).__name__}: {e})")
        return None
    if not isinstance(doc, dict) or doc.get("version") != version:
        got = doc.get("version") if isinstance(doc, dict) else None
        _warn(f"{path!r} has schema version {got!r}, expected {version} "
              f"(stale record)")
        return None
    if key is not None and doc.get("key") != key:
        _warn(f"{path!r} keyed for {doc.get('key')!r}, not {key!r}")
        return None
    try:
        return TuningRecord.from_dict(doc)
    except Exception as e:
        _warn(f"{path!r} malformed ({e})")
        return None


def resolve_tuning(tuning, *, key: Optional[str] = None
                   ) -> Optional[TuningRecord]:
    """Normalize the ``tuning=`` argument: ``None`` passes through, a
    :class:`TuningRecord` is key-checked, anything else is treated as a
    path and loaded via :func:`load_tuning` (same never-crash
    contract)."""
    if tuning is None:
        return None
    if isinstance(tuning, TuningRecord):
        if key is not None and tuning.key != key:
            _warn(f"record keyed for {tuning.key!r}, not {key!r}")
            return None
        return tuning
    return load_tuning(os.fspath(tuning), key=key)


def apply_tuning(record: Optional[TuningRecord], *, fb_ratio: int = 1,
                 update_delay: int = 0, flat: bool = True,
                 max_inflight_steps: Optional[int] = None
                 ) -> Dict[str, Any]:
    """Merge a record under the caller's kwargs: a knob the caller moved
    off its documented default (``fb_ratio=1``, ``update_delay=0``,
    ``flat=True``, ``max_inflight_steps=None``) always wins; the record
    only replaces untouched defaults. Returns the effective kwargs."""
    out = {"fb_ratio": int(fb_ratio), "update_delay": int(update_delay),
           "flat": bool(flat), "max_inflight_steps": max_inflight_steps}
    if record is None:
        return out
    best = record.best_candidate()
    if out["fb_ratio"] == 1:
        out["fb_ratio"] = int(best.R)
    if out["update_delay"] == 0:
        out["update_delay"] = int(best.D)
    if out["max_inflight_steps"] is None:
        out["max_inflight_steps"] = int(best.max_inflight_steps)
    if out["flat"] and best.grouping == "legacy":
        out["flat"] = False
    return out
