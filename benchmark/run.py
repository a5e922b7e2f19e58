"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up builds the port's detector with the
benchmark's weights from ``--seed``, makes the cell's inputs on the card,
and warms up every shape the window uses; the window then measures for
``--seconds``. ``--trace 1`` adds a short profiled segment after the
window and reports the cell's per-layer metrics in place of its
end-to-end ones. After the window the program's state is freed and the
plain reference checks what the timed path produced. The last line of
standard output is the result; the compared numbers, each beside its
limit, are the last lines of standard error. Without a card, or with
fewer cards than the cell asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness


def main(argv=None) -> int:
    started = harness.process_start()
    harness.cache_env()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    cell = harness.Cell(args.workload)
    chips = cell.entry["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); found "
                    f"{found}")
        return 2
    harness.log(f"nvidia-smi: {harness.power_limit()}")
    # One host thread for torch's CPU ops: the timed path's host work is
    # Python and launches, and idle worker threads only add noise.
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), started)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log("loaded JAX or the JAX package: " + ", ".join(loaded))
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, started: float) -> dict:
    """Set-up, window, traced segment, check: the result's dict. On the
    CPU (the harness's tests) the peak memory reads 0."""
    import torch

    from benchmark.drivers.common import breakdown, sync

    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    harness.log(f"device {kind}")
    runner = harness.driver(cell.traffic["kind"]).Runner(
        cell.config, cell.traffic, cell.limits, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    runner.setup()
    sync(device)
    setup_s = time.time() - started
    harness.log(f"set-up {setup_s:.3f} s")

    win = runner.window(seconds)
    rec = runner.trace() if trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    verdict = runner.check()
    checks = verdict["checks"]
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": win["attempted"], "failed": win["failed"]}
    info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
            "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        rec.update(runner.counts(verdict["rois"]))
        rec.update(kind=cell.traffic["kind"], host_ms=win["host_ms"],
                   window_s=win["seconds"], window_calls=win["attempted"],
                   peaks=harness.peaks(kind))
        metrics = {}
        for m in cell.per_layer():
            value = harness.reader(m["name"], cell.root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info.update(busy_s=rec["busy_us"] / 1e6, window_s=rec["span_us"] / 1e6)
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    result.update(metrics=metrics, device=info)
    if trace:
        result["breakdown"] = breakdown(rec)
    harness.log(json.dumps({k: v for k, v in verdict.items()
                            if k not in ("checks", "rois")}, default=str))
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
