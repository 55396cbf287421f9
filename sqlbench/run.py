"""One run of one benchmark cell of trino_tpu_torch.

    python3 sqlbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: generates the cell's configuration's
tables from the seed (its schema's generator, ``data.generator``), loads
them into the port's memory connector, starts the configuration's runner
behind the port's statement server, warms every template up through it,
then lets the traffic's streams (a child process) send statements for
``--seconds``. Once the window has closed it holds every statement's
rows against the plain NumPy reference and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also end standard error. Where an
end-to-end metric is read from the device's trace, an untraced run
records the device (``torch.profiler``, its activity only) over the
whole window.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
``configs/``, ``traffic/``, ``queries/``, ``reference/`` and
``metrics/``. Exits 2 without a result when the card is missing, 3 when
a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sqlbench import check, data, readers, system, workload  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "trino_tpu")
OUT_DIR = os.path.join(ROOT, "sqlbench_out")
#: seconds the streams may take past the window to finish what they sent
DRAIN_S = 120.0
#: seconds the warm-up may take
WARMUP_S = 900.0


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernel build lives in ``trino_tpu_torch/_build``)."""
    base = os.path.join(ROOT, ".sqlbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, os.path.join(base, sub))


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_cell(workload_name: str, bench: dict = None):
    """(benchmark, cell, configuration, traffic) of a cell of
    ``BENCHMARK.json`` (or of ``bench``, for the tests)."""
    if bench is None:
        bench = workload.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload_name not in cells:
        raise SystemExit(f"unknown workload {workload_name!r}; cells: "
                         f"{', '.join(cells)}")
    cell = cells[workload_name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = workload.read_json(os.path.join(ROOT, cfg["file"]))
    return bench, cell, config, workload.load_traffic(cell["traffic"])


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries the cell reports in this kind of run."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    e2e = {m["name"] for m in cell_metrics(bench, cell, False)}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in e2e]


class Streams:
    """The streams' child process (``streams.py``) and its lines."""

    def __init__(self, url: str, plan: dict):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "sqlbench", "streams.py"),
             url], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.lines = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.send(plan)

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def send(self, doc: dict):
        self.proc.stdin.write(json.dumps(doc) + "\n")
        self.proc.stdin.flush()

    def receive(self, timeout: float) -> dict:
        try:
            line = self.lines.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(f"the streams sent nothing in {timeout:.0f} s")
        if line is None:
            raise RuntimeError(
                f"the streams exited ({self.proc.wait()}) early")
        return json.loads(line)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.reader.join(timeout=10)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", sf: float = None, wrap_runner=None,
             bench: dict = None):
    """One run: returns (result line, the numbers compared, the window's
    records, the database). ``device``, ``sf``, ``wrap_runner`` (a
    function of the runner, which the server then serves) and ``bench``
    are for the harness's CPU tests."""
    bench, cell, config, traffic = load_cell(workload_name, bench)
    cuda = device == "cuda"
    if cuda:
        import torch

        torch.cuda.reset_peak_memory_stats()
    log = Log()
    db = data.generate(config, seed, sf)
    log.mark("generate")
    runner = system.make_runner(config, db, device)
    log.mark("load")
    if wrap_runner is not None:
        runner = wrap_runner(runner)
    timed = calls = recorder = None
    undo = None
    served = runner
    if trace:
        from sqlbench import devtrace, instrument

        served = timed = instrument.TimedRunner(runner)
        undo = instrument.read_operator_walls()
        if cuda:
            calls = instrument.KernelCalls(torch.device("cuda"))
            recorder = devtrace.Recorder(
                os.path.join(OUT_DIR, f"{workload_name}.trace.json"))
        if recorder is not None:
            side = recorder.warm(calls.probe)
            print(f"sqlbench: the side stream is {sorted(side)}",
                  file=sys.stderr)
        log.mark("instrument")
    card = None
    card_warm_s = 0.0
    if cuda and not trace and any(m["source"] == "device_trace" for m in
                                  cell_metrics(bench, cell, False)):
        from sqlbench import devtrace

        # an end-to-end metric of the device: the device is recorded over
        # the whole window
        card = devtrace.Recorder(
            os.path.join(OUT_DIR, f"{workload_name}.window.trace.json"))
        t_warm = time.time()
        card.warm_alone()
        card_warm_s = time.time() - t_warm
        log.mark("instrument")
    server = system.serve(served)
    plan = workload.plan(traffic, seed)
    streams = Streams(server.uri, plan)
    dtrace = None
    try:
        warm = streams.receive(WARMUP_S)["warmup"]
        bad = [r for r in warm if "error" in r]
        if bad:
            raise RuntimeError(f"warm-up statement failed: {bad[0]}")
        if cuda:
            torch.cuda.synchronize()
        # what set-up made lives for the whole run: out of the collector's
        # way, so a full collection in the window walks only what the
        # statements make
        gc.collect()
        gc.freeze()
        log.mark("warm-up")
        # the benchmark's own profiler is no part of the system's set-up
        setup_s = time.time() - T_START - card_warm_s
        if card is not None:
            card.start()
        streams.send({"go": seconds})
        t_go = time.time()
        if recorder is not None:
            lead = max(0.0, seconds - float(traffic["trace_seconds"]))
            time.sleep(max(0.0, t_go + lead - time.time()))
            t_ask = time.time()
            recorder.start()
            calls.on = True
            print(f"sqlbench: profiler started in {time.time() - t_ask:.3f}"
                  " s", file=sys.stderr)
            time.sleep(max(0.0, t_go + seconds - time.time()))
            calls.on = False
            recorder.close()
        done = streams.receive(seconds + DRAIN_S)
        log.mark("window")
        if card is not None:
            card.close()
            card.stop()
            dtrace = card.read()
            os.remove(card.path)
            print(f"sqlbench: device trace of the window, {dtrace.window_s:.3f}"
                  f" s, {len(dtrace.ops)} device ops", file=sys.stderr)
            log.mark("device trace")
        if recorder is not None:
            t_ask = time.time()
            recorder.stop()
            print(f"sqlbench: profiler stopped in {time.time() - t_ask:.3f}"
                  " s", file=sys.stderr)
            dtrace = recorder.read()
            print(f"sqlbench: trace of {dtrace.window_s:.3f} s, "
                  f"{len(dtrace.ops)} device ops, {dtrace.own_ops} of them "
                  "on the benchmark's side stream, left out",
                  file=sys.stderr)
    finally:
        streams.close()
        server.stop()
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    if calls is not None:
        calls.resolve()
        calls.close()
    if undo is not None:
        undo()
    del runner, served, server
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = check.check(done["records"], db)
    log.mark("reference")
    keep_records(workload_name, warm, done["records"])
    run = readers.Run(seconds=seconds, window=tuple(done["window"]),
                      records=done["records"], setup_s=setup_s,
                      executions=timed.executions if timed else None,
                      trace=dtrace,
                      kernel_calls=calls.calls if calls else None)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = readers.load(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": numbers[name], "max": limit}
              for name, limit in check.LIMITS.items()}
    checks["compared"] = {"value": numbers["compared"], "min": 1}
    correct = all(c["value"] <= c["max"] for c in checks.values()
                  if "max" in c) and numbers["compared"] >= 1
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = power_limit()
    line = {"correct": bool(correct), "attempted": len(done["records"]),
            "failed": numbers["failed"] + numbers["unanswered"],
            "metrics": metrics, "device": dev}
    if recorder is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s
        line["breakdown"] = breakdown(dtrace, run, timed)
    line["checks"] = checks
    return line, numbers, done["records"], db


class Log:
    """Set-up and check phases on standard error, in seconds."""

    def __init__(self):
        self.t = T_START

    def mark(self, phase: str):
        now = time.time()
        print(f"sqlbench: {phase} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def keep_records(workload_name: str, warm, records) -> None:
    """Every statement's template, parameters and times (not its rows),
    warm-up first, to ``sqlbench_out/<workload>.records.json``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    keep = ("stream", "seq", "template", "params", "t_post", "t_done",
            "latency_ms", "error", "plan_changes")
    with open(os.path.join(OUT_DIR, f"{workload_name}.records.json"),
              "w") as f:
        json.dump([{k: r[k] for k in keep if k in r}
                   for r in list(warm) + list(records)], f)


def breakdown(dtrace, run, timed) -> dict:
    """The device ops that took most time, and the longest idle gaps,
    each named by what the host was doing across it: the innermost
    operator active across the gap's middle, within the statements then
    running."""
    spans = []
    for e in timed.executions:
        name = e.sql.split()[0]
        for rec in run.records:
            if rec["sql"] == e.sql:
                name = rec["template"]
                break
        spans.append((e.t0, e.t1, name, ""))
        for op in e.stats.get("operators", ()):
            if "first_s" in op:
                spans.append((op["first_s"], op["last_s"], name, op["name"]))
        for s in e.stats.get("trace") or ():
            if s.get("attrs", {}).get("span_kind") == "operator":
                spans.append((s["start"], s["attrs"].get(
                    "last_activity", s["end"]), name, s["name"]))
    gaps = []
    for a, b in sorted(dtrace.idle_gaps(), key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        running = sorted({s[2] for s in open_})
        ops = sorted((s for s in open_ if s[3]), key=lambda s: s[1] - s[0])
        label = "+".join(running) or "no statement running"
        if ops:
            label += ": " + ops[0][3]
        gaps.append([label, b - a])
    return {"device_ops": dtrace.top_ops(10), "idle_gaps": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    _, cell, _, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"sqlbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    line, numbers, _, _ = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"sqlbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({k: v for k, v in numbers.items()}), file=sys.stderr)
    for name, c in line["checks"].items():
        bound = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
