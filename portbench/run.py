"""Run one cell of the port's benchmark on this machine's CUDA device:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the last line of standard output is the result with
the cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the result carries the per-layer metrics, the
device's busy and window seconds and a breakdown. Either way the outputs
of the timed path are held to the plain reference after the window
(``correct``), each compared number beside its limit as the last lines
of standard error and as the result's last key. Exits non-zero and
prints no result where there is no CUDA device, or too few, or where a
JAX module was loaded.
"""

from __future__ import annotations

import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True, help="the cell's name (workloads/<name>.json)")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {harness.card_line()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    driver = importlib.import_module("portbench.drivers." + cell["mix"]["kind"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                     T_ORIGIN)
    return report(cell, args, out)


def report(cell, args, out: dict) -> int:
    """Print the result line (and the checks on standard error); 3 where a
    JAX module is loaded."""
    from portbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "device": out["device"]}
    reading = out["reading"]
    if args.trace:
        trace = reading.trace
        result["device"]["busy_s"] = trace.busy_s()
        result["device"]["window_s"] = trace.window_s
        result["metrics"] = harness.per_layer(reading)
        result["breakdown"] = harness.breakdown(trace, reading.extra["labelled"])
        print(f"portbench: launches a unit {json.dumps(reading.launches)}", file=sys.stderr)
        mine = sorted({harness.kernel_function(k[0]) for k in trace.kernels
                       if harness.is_handwritten(k[0])})
        copies = {}
        for name, _, _ in trace.ops:
            if name.startswith(("Memcpy", "Memset")):
                copies[name] = copies.get(name, 0) + 1
        print(f"portbench: traced {len(trace.ops)} device operations, {trace.units} units; "
              f"hand-written kernels {mine}; copies {copies}", file=sys.stderr)
    else:
        result["metrics"] = out["metrics"]
    print(f"portbench: memory peak {result['device']['memory_peak_bytes']} bytes",
          file=sys.stderr)
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
