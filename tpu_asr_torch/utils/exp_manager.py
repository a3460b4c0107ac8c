"""Experiment helpers: the port's counterpart of tpu_asr/utils/exp_manager.py.

- `setup_experiment`: outputs/<project>/<name>[-vN] (PRJ_NAME / EXP_NAME
  from the environment), with a config snapshot.
- `StepTimer`: per-step wall times, mean / p50 / p95.
- `profile_trace`: a `torch.profiler` trace behind a flag (Chrome trace
  JSON under <workdir>/profile), in place of `jax.profiler`.
- `StragglerDetector`, `maybe_inject_fault`, `write_heartbeat`,
  `check_heartbeats`: the fault-tolerance hooks. A process's rank is its
  rank in the process group (parallel/mesh.py; 0 without one).

Under data parallelism rank 0 picks the version suffix and every rank takes
it (`broadcast_int`), and the straggler report gathers every rank's mean.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import asdict, is_dataclass
from pathlib import Path
from typing import Dict, Optional

from tpu_asr_torch.parallel.mesh import (broadcast_int, cross_process_sum,
                                         is_main_process, process_count,
                                         process_index, sync_processes)


def setup_experiment(output_dir, config=None, project: Optional[str] = None,
                     name: Optional[str] = None,
                     version_rerun: bool = True) -> Path:
    """Create outputs/<project>/<name>[-vN] and snapshot the config (rank 0
    decides the suffix and writes; the others wait for it)."""
    project = project or os.getenv("PRJ_NAME") or "default"
    name = name or os.getenv("EXP_NAME") or "run"
    workdir = Path(output_dir) / project / name
    n = 0
    if is_main_process() and version_rerun and workdir.exists() \
            and any(workdir.iterdir()):
        n = 1
        while (Path(output_dir) / project / f"{name}-v{n}").exists():
            n += 1
    n = broadcast_int(n)
    if n:
        workdir = Path(output_dir) / project / f"{name}-v{n}"
    if is_main_process():
        workdir.mkdir(parents=True, exist_ok=True)
        if config is not None:
            cfg = asdict(config) if is_dataclass(config) else config
            (workdir / "config.json").write_text(json.dumps(cfg, indent=2,
                                                            default=str))
    sync_processes("setup_experiment")
    return workdir


class StepTimer:
    """Accumulates step wall times; `summary()` -> mean/p50/p95/total."""

    def __init__(self, window: int = 1000):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        xs = sorted(self._times)
        n = len(xs)
        return {"step_time_mean": sum(xs) / n, "step_time_p50": xs[n // 2],
                "step_time_p95": xs[min(n - 1, int(n * 0.95))],
                "steps_measured": float(n)}


@contextlib.contextmanager
def profile_trace(workdir, enabled: bool = False):
    """torch.profiler over the block (CPU and CUDA activities), its Chrome
    trace written to <workdir>/profile/trace.json; a no-op unless
    enabled."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = Path(workdir) / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield trace_dir
    prof.export_chrome_trace(str(trace_dir / "trace.json"))


class StragglerDetector:
    """Per-step wall times of this process; `report()` gathers every rank's
    mean and flags ranks slower than `threshold` x the median (every rank
    must call it together)."""

    def __init__(self, threshold: float = 1.25, window: int = 100):
        self.threshold = threshold
        self.window = window
        self._times = []

    def tick(self, dt_s: float) -> None:
        self._times.append(float(dt_s))
        if len(self._times) > self.window:
            self._times = self._times[-self.window:]

    def report(self) -> Dict:
        import numpy as np
        vec = np.zeros(process_count(), np.float64)
        vec[process_index()] = (float(np.mean(self._times)) if self._times
                                else 0.0)
        per_rank = cross_process_sum(vec).tolist()
        med = float(np.median(per_rank))
        return {"per_rank_mean_s": per_rank, "median_s": med,
                "threshold": self.threshold,
                "stragglers": [i for i, t in enumerate(per_rank)
                               if med > 0 and t > self.threshold * med]}


def maybe_inject_fault(spec: Optional[str], step: int,
                       n_done: int = 1) -> None:
    """`spec` "rank_killed:<rank>:<step>" exits hard (os._exit(1)) and
    "rank_hung:<rank>:<step>" sleeps forever, when this process is <rank>
    and <step> falls in (step - n_done, step]; a no-op otherwise."""
    if not spec:
        return
    kind, rank, at = spec.split(":")
    at = int(at)
    if process_index() != int(rank) or not (step - n_done < at <= step):
        return
    if kind == "rank_killed":
        os._exit(1)
    elif kind == "rank_hung":
        while True:
            time.sleep(60)
    else:
        raise ValueError(f"unknown simulated fault kind: {kind!r}")


def write_heartbeat(workdir, step: int) -> None:
    """<workdir>/heartbeats/rank<i>: the last step and wall time (atomic
    rename)."""
    hb = Path(workdir) / "heartbeats"
    hb.mkdir(parents=True, exist_ok=True)
    rank = process_index()
    tmp = hb / f".rank{rank}.tmp"
    tmp.write_text(json.dumps({"step": int(step), "time": time.time()}))
    tmp.rename(hb / f"rank{rank}")


def check_heartbeats(workdir, timeout_s: float = 60.0) -> Dict:
    """Ranks whose heartbeat is older than `timeout_s` (hung or dead)."""
    hb = Path(workdir) / "heartbeats"
    now = time.time()
    stale, live = [], {}
    for f in sorted(hb.glob("rank*")):
        rec = json.loads(f.read_text())
        rank = int(f.name[4:])
        live[rank] = rec
        if now - rec["time"] > timeout_s:
            stale.append(rank)
    return {"stale": stale, "ranks": live}


def crossed(step: int, n_done: int, every: int) -> bool:
    """Whether the last `n_done` steps, ending at `step`, crossed a
    multiple of `every` (the interval-crossing test)."""
    return bool(every) and step // every != (step - n_done) // every
