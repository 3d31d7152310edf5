"""The harness: runs one cell of ``BENCHMARK.json`` once and prints its line.

Everything is found by name.  A cell (``workloads`` entry) names its
configuration, whose file (``configs/<config>.json``) names the runner that
builds and drives the program (``runners/<runner>.py``); its traffic mix is
``traffic/<traffic>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  A later cell, mix, configuration or metric is new
files and new entries, never an edit of these.

A runner module has ``make(config, mix, seed, device, spans)`` returning an
object with:

* ``setup()``: builds the program, draws weights and inputs from the seed,
  warms up the cell's own shapes;
* ``window(seconds, tracing)``: drives the measured window; returns
  ``{"metrics": {name: value}, "attempted", "failed", "counters"}``, the
  end-to-end metrics taken on the host clock and the counters the per-layer
  readers take;
* ``release()``: frees the program's state;
* ``check()``: compares what the window produced with the plain reference;
  returns ``[{"name", "value", "limit"}]``, each passing while value <= limit.

A reader module has ``read(trace) -> float | None`` (:class:`Trace`); None
leaves its metric out of the line.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: Top-level module names that may not be loaded when the window closes:
#: the reference package, JAX and its libraries.  Compared whole, so the
#: port (``repro_torch``) is not one of them.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this machine shows."""


# ------------------------------------------------------------------ loading


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (runners and readers are
    found by file name, which may hold characters a package name may not)."""
    key = f"perfbench_{name}".replace(".", "_").replace("-", "_").replace("/", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def resolve(workload: str, root: Path = ROOT, manifest: dict | None = None) -> Cell:
    """The cell ``workload`` with its configuration, mix and metrics."""
    root = Path(root)
    man = load_manifest(root) if manifest is None else manifest
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, mix=mix,
        end_to_end=[m for m in man["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if applies(m, workload)],
    )


# -------------------------------------------------------------------- spans


class Spans:
    """Host-clock spans the harness records around calls into the program's
    layers.  While tracing, each is also a profiler range named
    ``pb:<name>``, so idle gaps on the device can be told by what the host
    was doing."""

    def __init__(self):
        self.tracing = False
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.tracing:
            import torch

            rf = torch.profiler.record_function(f"pb:{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)


@dataclass
class Trace:
    """What a traced window gives the per-layer readers.  Times in seconds
    on the profiler's clock."""

    window_s: float  # the traced window, host clock
    busy_s: float  # union of the device's operations inside the window
    device_ops: list = field(default_factory=list)  # (name, start, end)
    spans: dict = field(default_factory=dict)  # name -> [seconds]
    counters: dict = field(default_factory=dict)  # from the runner
    ranges: dict = field(default_factory=dict)  # span name -> [(start, end)], profiler clock

    def device_seconds(self, pred) -> float:
        return sum(e - s for n, s, e in self.device_ops if pred(n))

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.device_ops if pred(n))

    def device_seconds_inside(self, span: str) -> float:
        """Device time of the operations that ran inside the span's ranges
        (a span synchronised on both ends holds just its own work)."""
        rs = sorted(self.ranges.get(span, []))
        total, j = 0.0, 0
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            while j < len(rs) and rs[j][1] <= s:
                j += 1
            if j < len(rs) and rs[j][0] <= s:
                total += min(e, rs[j][1]) - s
        return total


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals: device busy time
    without counting overlaps twice (copied from the program's
    ``bench/table1.busy_us``)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] in which no device operation ran."""
    gaps, cur = [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_gaps(gaps, host_events) -> dict[str, float]:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost harness span (``pb:``) and the innermost host operation open
    there."""
    import heapq

    def innermost(events):
        evs = sorted(events, key=lambda e: e[1])
        out, heap, j = [], [], 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            m = (a + b) / 2
            while j < len(evs) and evs[j][1] <= m:
                heapq.heappush(heap, (-evs[j][1], evs[j][2], evs[j][0]))
                j += 1
            while heap and heap[0][1] <= m:
                heapq.heappop(heap)
            out.append(((a, b), heap[0][2] if heap else None))
        return out

    spans = innermost([e for e in host_events if e[0].startswith("pb:")])
    ops = dict(innermost([e for e in host_events if not e[0].startswith("pb:")]))
    by: dict[str, float] = {}
    for (a, b), sp in spans:
        op = ops.get((a, b))
        label = f"{sp[3:] if sp else 'outside spans'} / {op or 'no host op'}"
        by[label] = by.get(label, 0.0) + (b - a)
    return by


class Profile:
    """``torch.profiler`` over the traced window, reduced to device
    operations (kernels, copies, fills) and host ranges."""

    def __init__(self):
        import torch

        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def reduce(self):
        """``(device_ops, host_events, window)``: device operations and host
        ranges as ``(name, start_s, end_s)``, and the ``pb:window`` range.
        Read from the profiler's raw events: building its ``FunctionEvent``
        tree takes minutes for a window of a few hundred thousand."""
        from torch.autograd import DeviceType

        dev, host, window = [], [], None
        raw = self.prof.profiler.kineto_results.events()
        t0 = min((e.start_ns() for e in raw), default=0)
        for ev in raw:
            name = ev.name()
            s = (ev.start_ns() - t0) * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if ev.device_type() == DeviceType.CUDA:
                # a profiler range's shadow on the device's timeline is not work
                if not (name.startswith("pb:") or ev.is_user_annotation()):
                    dev.append((name, s, e))
            else:
                host.append((name, s, e))
                if name == "pb:window":
                    window = (s, e)
        return dev, host, window


# ----------------------------------------------------------------- the card


def card_info(index: int = 0) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        name, limit = (v.strip() for v in out.stdout.strip().split(","))
        return {"name": name, "power_limit_w": float(limit)}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {"name": None, "power_limit_w": None}


class PowerSampler:
    """``nvidia-smi`` power draw, SM clock and temperature, sampled every
    ``period_ms`` beside the window in a process of its own."""

    FIELDS = ("power_draw_w", "sm_clock_mhz", "temperature_c")

    def __init__(self, index: int = 0, period_ms: int = 250):
        self.cmd = ["nvidia-smi", "-i", str(index),
                    "--query-gpu=power.draw,clocks.sm,temperature.gpu",
                    "--format=csv,noheader,nounits", f"-lms={period_ms}"]
        self.rows: list[tuple[float, ...]] = []
        self.proc = None
        self.reader = None

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.rows.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.reader.join(timeout=10)

    def summary(self) -> dict:
        out = {"samples": len(self.rows)}
        for i, f in enumerate(self.FIELDS):
            vals = [r[i] for r in self.rows if len(r) == len(self.FIELDS)]
            if vals:
                out[f] = {"median": statistics.median(vals), "min": min(vals), "max": max(vals)}
        return out


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc), else since the
    harness was imported."""
    try:
        start = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), each compared whole."""
    return sorted({m.split(".", 1)[0] for m in (sys.modules if names is None else names)}
                  & FORBIDDEN)


# ---------------------------------------------------------------------- run


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device=None, manifest: dict | None = None, log=sys.stderr) -> dict:
    """Run one cell once; return the result line's object.  ``device=None``
    is the CUDA card, and the run refuses to start without enough cards;
    ``device='cpu'`` (tests) runs the same path on the CPU and reports no
    device numbers."""
    cell = resolve(workload, root, manifest)
    on_card = device is None or str(device).startswith("cuda")
    if on_card:
        require_cards(cell.chips)
    import torch

    dev = torch.device("cuda" if device is None else device)
    runner_mod = load_module(root / "perfbench" / "runners" / f"{cell.config['runner']}.py",
                             f"runner_{cell.config['runner']}")
    spans = Spans()
    runner = runner_mod.make(cell.config, cell.mix, seed, dev, spans)
    runner.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age()
    power = PowerSampler() if on_card else contextlib.nullcontext()
    breakdown = busy = None
    with power:
        if trace:
            spans.tracing = True
            prof = Profile()
            with prof:
                with spans.span("window"):
                    res = runner.window(seconds, True)
            spans.tracing = False
        else:
            res = runner.window(seconds, False)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if trace:
        dev_ops, host, win = prof.reduce()
        lo, hi = win
        inside = [(n, max(s, lo), min(e, hi)) for n, s, e in dev_ops if e > lo and s < hi]
        busy = busy_seconds([(s, e) for _, s, e in inside])
        ranges: dict = {}
        for n, s, e in host:
            if n.startswith("pb:"):
                ranges.setdefault(n[3:], []).append((s, e))
        tr = Trace(window_s=hi - lo, busy_s=busy, device_ops=inside,
                   spans=dict(spans.seconds), counters=res["counters"], ranges=ranges)
        for m in cell.per_layer:
            path = root / "perfbench" / "metrics" / f"{m['name']}.py"
            v = load_module(path, f"metric_{m['name']}").read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        by_op: dict[str, float] = {}
        for n, s, e in inside:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        gaps = label_gaps(idle_gaps(inside, lo, hi), host)
        breakdown = {
            "device_ops": [[n[:160], v] for n, v in
                           sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n[:160], v] for n, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        }
        del prof, dev_ops, host
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else res["metrics"].get(m["name"])
            if v is None:
                raise RuntimeError(f"the window gave no {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    runner.release()
    checks = runner.check()
    # on the card the process is the benchmark's own; a CPU test's process
    # may hold the JAX package for other tests
    found = forbidden_modules() if on_card else []
    if found:
        raise RuntimeError(f"modules of JAX or the reference package are loaded: {found}")
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks)
    if on_card:
        card = card_info(dev.index or 0)
        device_obj = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                      "count": cell.chips, "memory_peak_bytes": int(peak)}
        if trace:
            device_obj.update(busy_s=busy, window_s=hi - lo)
        line = json.dumps({"card": card, "power": power.summary(), "window_s": res["window_s"]})
        print(line)
        print(line, file=log)
    else:
        device_obj = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"correct": correct, "attempted": int(res["attempted"]), "failed": int(res["failed"]),
           "metrics": metrics, "device": device_obj}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=log)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"perfbench: the program cannot be imported here: {e}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    sys.stdout.flush()
    return 0
